"""Frame-level decoder driver: the vp9_receive_compressed_data state machine.

Parity with vp9/decoder/vp9_decoder.c (vp9_receive_compressed_data:407,
swap_frame_buffers:334, ref-map updates), vp9/vp9_dx_iface.c (superframe
handling), vp9_setup_past_independence (vp9/common/vp9_entropymode.c:425),
and the end-of-frame backward adaptation (vp9_decodeframe.c:3571-3586).

The C++ host parser (native/) turns each frame into a FramePlan, and a
recon_fn reconstructs it: by default `TorchRecon("cuda")`
(runtime/pipeline.py), the frame step on the card.
"""

from __future__ import annotations

import numpy as np

from ..ops.ref import recon as ref_recon
from ..utils import spans
from . import constants as C
from .bitreader import parse_superframe_index
from .headers import BitstreamError, FrameHeader, parse_uncompressed_header


class DecodedFrame:
    """One output frame (what vpx_codec_get_frame yields)."""

    def __init__(self, planes, width, height, bit_depth, ss_x, ss_y):
        self.planes = planes
        self.width = width
        self.height = height
        self.bit_depth = bit_depth
        self.ss_x = ss_x
        self.ss_y = ss_y

    def visible_planes(self):
        """Planes cropped to display size (Y, U, V), in an
        api.visible_planes span (`utils/spans.py`): reading a frame's
        planes first fetches them from the device."""
        with spans.span("api.visible_planes"):
            return self._crop()

    def _crop(self):
        """visible_planes without its span (for a caller inside another
        api.* span)."""
        w, h = self.width, self.height
        cw = (w + self.ss_x) >> self.ss_x
        ch = (h + self.ss_y) >> self.ss_y
        y = self.planes[0][:h, :w]
        u = self.planes[1][:ch, :cw]
        v = self.planes[2][:ch, :cw]
        if self.bit_depth == 8:
            return [y.astype(np.uint8), u.astype(np.uint8),
                    v.astype(np.uint8)]
        return [y, u, v]


def _peek_frame_kind(payload: bytes) -> str:
    """'resync' for key/intra-only frames (they clear pbi->need_resync,
    vp9_decodeframe.c read_uncompressed_header), 'show' for
    show_existing_frame (exempt from the resync gate), 'other' else."""
    from .bitreader import BitReader
    rb = BitReader(payload)
    if rb.f(2) != C.VP9_FRAME_MARKER:
        return "other"
    profile = rb.read_bit() | (rb.read_bit() << 1)
    if profile > 2:
        profile += rb.read_bit()
    if rb.read_bit():            # show_existing_frame
        return "show"
    frame_type = rb.read_bit()
    if frame_type == C.KEY_FRAME:
        return "resync"
    show_frame = rb.read_bit()
    rb.read_bit()                # error_resilient_mode
    intra_only = (not show_frame) and rb.read_bit()
    return "resync" if intra_only else "other"


def get_tile_buffers(data: bytes, offset: int, hdr: FrameHeader):
    """Split the tile data region into per-tile byte spans
    (vp9_decodeframe.c get_tile_buffers)."""
    tile_cols = 1 << hdr.log2_tile_cols
    tile_rows = 1 << hdr.log2_tile_rows
    spans = []
    pos = offset
    for tr in range(tile_rows):
        row_spans = []
        for tc in range(tile_cols):
            is_last = (tr == tile_rows - 1) and (tc == tile_cols - 1)
            if is_last:
                size = len(data) - pos
            else:
                if pos + 4 > len(data):
                    raise BitstreamError("truncated tile length")
                size = int.from_bytes(data[pos:pos + 4], "big")
                pos += 4
            if pos + size > len(data):
                raise BitstreamError("tile overruns frame buffer")
            row_spans.append((pos, size))
            pos += size
        spans.append(row_spans)
    return spans


def _tile_spans(payload, ref_sizes):
    """Per-tile (byte_offset, size) spans of a frame payload, raster
    order (VP9D_GET_TILE_DATA analog; the reference's libvpx v1.9
    predates the control).  Returns None for show_existing / missing
    payloads."""
    if not payload:
        return None
    try:
        hdr = parse_uncompressed_header(payload, ref_sizes=ref_sizes)
        if hdr.show_existing_frame:
            return None
        off = (hdr.uncompressed_header_size_in_bytes
               + hdr.header_size_in_bytes)
        spans = get_tile_buffers(payload, off, hdr)
        return [(pos, size) for row in spans for (pos, size) in row]
    except Exception:
        return None


class NativeVp9Decoder:
    """Single-stream VP9 decoder: the C++ host entropy decoder (native/)
    and a recon_fn(plan, refs) -> planes, `TorchRecon("cuda")` unless the
    caller passes one."""

    def __init__(self, recon_fn=None, threads: int = 1):
        from ..native import NativeParser, ShowExisting
        if recon_fn is None:
            from ..runtime.pipeline import TorchRecon
            recon_fn = TorchRecon("cuda")
        self._ShowExisting = ShowExisting
        self._parser = NativeParser(threads=threads)
        self.ref_slots = [None] * C.REF_FRAMES
        self._outputs = []
        self._recon_fn = recon_fn
        # pbi->need_resync (vp9_decoder.h): starts 1, cleared by a key or
        # intra-only frame, set by any decode error; inter frames are
        # refused while set
        self.need_resync = 1
        self.last_qindex = 0
        self.last_ref_updates = 0
        self.skip_loop_filter = False
        self._last_payload = None
        self.last_ref_buf = None  # frame_refs[0] (VP8_COPY_REFERENCE)

    @property
    def last_header_sizes(self):
        """(uncompressed, compressed) header byte sizes of the last
        frame (VP9D_GET_FRAME_HEADER_INFO) — parsed lazily; the native
        parser does not export offsets."""
        if not self._last_payload:
            return (0, 0)
        hdr = parse_uncompressed_header(
            self._last_payload, ref_sizes=lambda i: (
                (self.ref_slots[i].width, self.ref_slots[i].height)
                if self.ref_slots[i] else (0, 0)))
        return (hdr.uncompressed_header_size_in_bytes,
                hdr.header_size_in_bytes)

    @property
    def last_tile_data(self):
        """Per-tile (byte_offset, size) spans of the last frame's
        payload (VP9D_GET_TILE_DATA)."""
        def ref_sizes(i):
            rb = self.ref_slots[i]
            return (rb.width, rb.height) if rb else (0, 0)
        return _tile_spans(self._last_payload, ref_sizes)

    def decode(self, data: bytes):
        try:
            for off, sz in parse_superframe_index(data):
                self._decode_one(data[off:off + sz])
        except Exception:
            self.need_resync = 1
            raise

    def get_frame(self):
        if self._outputs:
            return self._outputs.pop(0)
        return None

    def frames(self):
        while self._outputs:
            yield self._outputs.pop(0)

    def _decode_one(self, payload: bytes):
        if self.need_resync and _peek_frame_kind(payload) == "other":
            raise BitstreamError(
                "keyframe / intra-only frame required to reset decoder "
                "state (resync)")
        self._last_payload = payload
        with spans.span("vp9.parse"):
            plan = self._parser.parse(payload)
        if isinstance(plan, self._ShowExisting):
            rb = self.ref_slots[plan.frame_to_show]
            if rb is None:
                raise BitstreamError("show_existing of empty slot")
            self._outputs.append(DecodedFrame(
                rb.planes, rb.width, rb.height, rb.bit_depth,
                rb.ss_x, rb.ss_y))
            return
        hdr = plan.hdr
        if hdr.frame_is_intra_only:
            self.need_resync = 0
        self.last_qindex = hdr.base_qindex
        self.last_ref_updates = hdr.refresh_frame_flags
        if self.skip_loop_filter:
            hdr.lf.filter_level = 0  # VP9_SET_SKIP_LOOP_FILTER
        refs = {}
        if not hdr.frame_is_intra_only:
            for i in range(C.REFS_PER_FRAME):
                refs[C.LAST_FRAME + i] = self.ref_slots[hdr.ref_frame_idx[i]]
            # frame_refs[0] of the current frame (VP8_COPY_REFERENCE
            # reads it: vp9_copy_reference_dec, get_ref_frame(cm, 0))
            self.last_ref_buf = refs[C.LAST_FRAME]
        planes = self._recon_fn(plan, refs)
        new_ref = ref_recon.RefBuffer(planes, hdr.width, hdr.height,
                                      hdr.bit_depth, hdr.subsampling_x,
                                      hdr.subsampling_y)
        for i in range(C.REF_FRAMES):
            if hdr.refresh_frame_flags & (1 << i):
                self.ref_slots[i] = new_ref
        if hdr.show_frame:
            self._outputs.append(DecodedFrame(
                planes, hdr.width, hdr.height, hdr.bit_depth,
                hdr.subsampling_x, hdr.subsampling_y))


def native_decode_stream_md5(ivf_path: str, max_frames: int = 10 ** 9,
                             recon_fn=None, lag: int = 32):
    """Decode an IVF file, yielding (index, md5 hex) per shown frame
    (decode_to_md5 parity), with NativeVp9Decoder(recon_fn).

    Consumes output frames `lag` behind the decode front so a device
    recon backend with a batched output ring (TorchRecon) amortizes its
    device->host fetches."""
    from collections import deque
    from ..containers import IvfReader
    from ..utils.md5 import frame_md5
    dec = NativeVp9Decoder(recon_fn=recon_fn)
    n = 0
    q = deque()
    with IvfReader(ivf_path) as r:
        for data, _pts in r:
            dec.decode(data)
            q.extend(dec.frames())
            while len(q) > lag:
                yield n, frame_md5(q.popleft().visible_planes())
                n += 1
                if n >= max_frames:
                    return
    while q:
        yield n, frame_md5(q.popleft().visible_planes())
        n += 1
        if n >= max_frames:
            return
