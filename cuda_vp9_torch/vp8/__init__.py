"""VP8 codec (RFC 6386), decoded on the host.

Full decode path of the reference's vp8/ codec (SURVEY S18): host
entropy parse + NumPy reconstruction of key AND inter frames
(last/golden/altref references, NEAREST/NEAR/ZERO/NEW/SPLIT motion,
six-tap and bilinear sub-pel MC), error concealment (concealment.py)
and the display-side postproc (postproc.py), validated per-frame
against libavcodec's normative `vp8` decoder MD5s.  The reference
decodes VP8 on the CPU too: its GPU passes are VP9's only.  Plus a VP8
encoder (encoder.py): keyframe intra + P-frames with loop filter and
one-pass rate control, whose in-loop reconstruction is bit-identical to
the decoder by construction.  Nothing here puts work on a torch device.
"""

import numpy as np

from .decoder import ALTREF, GOLDEN, LAST, Vp8Decoder, Vp8Error  # noqa: F401
from .encoder import Vp8Encoder  # noqa: F401


class Vp8StreamDecoder:
    """Stream-level VP8 decoder with the same decode()/frames() surface
    as NativeVp9Decoder (so the codec API and vpxdec work unchanged).

    With `use_postproc` (VPX_CODEC_USE_POSTPROC) shown frames pass
    through vp8_post_proc_frame (vp8/postproc.py); `postproc_cfg`
    defaults to DEBLOCK|DEMACROBLOCK at deblocking_level 4 like the
    reference (vp8_dx_iface.c:343-349) until VP8_SET_POSTPROC
    overrides it.

    After each frame, `last_qindex`, `last_ref_updates` and
    `last_ref_used` hold what VPXD_GET_LAST_QUANTIZER,
    VP8D_GET_LAST_REF_UPDATES and VP8D_GET_LAST_REF_USED return
    (vp8_dx_iface.c vp8_get_quantizer, vp8_get_last_ref_updates,
    vp8_get_last_ref_frame): the frame's base q index, its refresh flags
    and the references its macroblocks predict from, as VP8_LAST_FRAME
    (1) | VP8_GOLD_FRAME (2) | VP8_ALTR_FRAME (4)."""

    def __init__(self, ec_enabled: bool = False, use_postproc: bool = False):
        self._dec = Vp8Decoder(ec_enabled=ec_enabled)
        self._out = []
        self.last_qindex = 0
        self.last_ref_updates = 0
        self.last_ref_used = 0
        self.use_postproc = use_postproc
        self.postproc_cfg = None   # (flags, deblocking_level, noise_level)
        self._noise = None
        # MFQE postproc state (postproc.c postproc_state): previous
        # displayed frame (mb-aligned), q trail, frame counter
        self._pp_prev = None
        self._pp_last_q = 0
        self._pp_last_valid = False
        self._pp_frames = 0

    @property
    def frame_corrupt(self) -> bool:
        return self._dec.frame_corrupt

    def _postproc(self, hdr, planes):
        from . import postproc as pp
        if self.postproc_cfg is None:
            flags = pp.VP8D_DEBLOCK | pp.VP8D_DEMACROBLOCK
            deblock_level, noise_level = 4, 0
        else:
            flags, deblock_level, noise_level = self.postproc_cfg
        dec = self._dec
        if not flags:
            self._pp_last_q = dec.pp_base_qindex
            self._pp_last_valid = True
            return planes
        if self._noise is None:
            self._noise = pp.NoiseState()
        cur = dec.pp_planes
        # MFQE gating (postproc.c:202-205): after a quality drop
        # (qcurr - qlast >= 20 from a good frame) blend static blocks
        # toward the previous displayed frame, then deblock the result
        use_mfqe = (
            (flags & pp.VP8D_MFQE) and self._pp_last_valid
            and self._pp_prev is not None
            and self._pp_frames > 10
            and self._pp_last_q < 60
            and dec.pp_base_qindex - self._pp_last_q >= 20
            and self._pp_prev[0].shape == cur[0].shape)
        if use_mfqe:
            cur = pp.multiframe_quality_enhance(
                cur, self._pp_prev, dec.pp_mode, dec.pp_mvs,
                dec.pp_bmvs, dec.pp_skip, dec.pp_base_qindex,
                self._pp_last_q, dec.pp_frame_type)
            self._pp_last_q = (3 * self._pp_last_q
                               + dec.pp_base_qindex) >> 2
        else:
            self._pp_last_q = dec.pp_base_qindex
        self._pp_last_valid = True
        out = pp.post_proc_frame(
            cur, dec.pp_skip, dec.pp_filter_level,
            flags & ~pp.VP8D_MFQE, deblock_level,
            noise_level, hdr.width, hdr.height, self._noise)
        # remember the displayed frame mb-aligned for the next MFQE
        # blend (pad region replicates edges; the reference keeps its
        # own aligned post_proc_buffer)
        if flags & pp.VP8D_MFQE:
            h16, w16 = cur[0].shape
            prev = []
            for p, (hh, ww) in zip(out, ((h16, w16),
                                         (h16 // 2, w16 // 2),
                                         (h16 // 2, w16 // 2))):
                c = np.zeros((hh, ww), np.uint8)
                c[:p.shape[0], :p.shape[1]] = p
                if p.shape[1] < ww:
                    c[:p.shape[0], p.shape[1]:] = p[:, -1:]
                if p.shape[0] < hh:
                    c[p.shape[0]:, :] = c[p.shape[0] - 1, :]
                prev.append(c)
            self._pp_prev = prev
        return out

    def decode(self, data: bytes) -> None:
        from ..decoder.frame import DecodedFrame
        hdr, planes = self._dec.decode(data)
        self.last_qindex = hdr.base_qindex
        self.last_ref_updates = (hdr.refresh_last | hdr.refresh_golden << 1
                                 | hdr.refresh_alt << 2)
        used = np.unique(self._dec._lf_refs)
        self.last_ref_used = sum(flag for ref, flag in (
            (LAST, 1), (GOLDEN, 2), (ALTREF, 4)) if ref in used)
        self._pp_frames += 1
        if hdr.show_frame:
            if self.use_postproc:
                planes = self._postproc(hdr, planes)
            self._out.append(DecodedFrame(
                list(planes), hdr.width, hdr.height, 8, 1, 1))

    def frames(self):
        out, self._out = self._out, []
        return out
