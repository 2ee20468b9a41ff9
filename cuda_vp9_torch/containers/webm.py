"""WebM (Matroska) demuxer: extract VP9/VP8 frames from .webm files.

Pure-Python EBML parse, equivalent in capability to the reference's
webmdec.cc (libwebm-based): locates the first video track, iterates
Clusters -> SimpleBlocks/BlockGroups, and yields frame payloads with
timestamps.  Lacing (Xiph/fixed/EBML) is supported.

Reference: libvpx/webmdec.cc (webm_read_frame), Matroska spec element IDs.
"""

from __future__ import annotations

import io
from typing import Iterator, Optional, Tuple

# EBML element IDs (Matroska)
_EBML = 0x1A45DFA3
_SEGMENT = 0x18538067
_INFO = 0x1549A966
_TIMECODE_SCALE = 0x2AD7B1
_TRACKS = 0x1654AE6B
_TRACK_ENTRY = 0xAE
_TRACK_NUMBER = 0xD7
_TRACK_TYPE = 0x83
_CODEC_ID = 0x86
_VIDEO = 0xE0
_PIXEL_WIDTH = 0xB0
_PIXEL_HEIGHT = 0xBA
_CLUSTER = 0x1F43B675
_CLUSTER_TIMECODE = 0xE7
_SIMPLE_BLOCK = 0xA3
_BLOCK_GROUP = 0xA0
_BLOCK = 0xA1

_TRACK_TYPE_VIDEO = 1


def _read_vint(f, keep_marker: bool) -> Optional[Tuple[int, int]]:
    """Read an EBML variable-length integer.  Returns (value, length)."""
    b0 = f.read(1)
    if not b0:
        return None
    b0 = b0[0]
    if b0 == 0:
        return None
    length = 1
    mask = 0x80
    while not (b0 & mask):
        mask >>= 1
        length += 1
        if length > 8:
            return None
    value = b0 if keep_marker else (b0 & (mask - 1))
    rest = f.read(length - 1)
    if len(rest) != length - 1:
        return None
    for b in rest:
        value = (value << 8) | b
    return value, length


def _read_id(f):
    r = _read_vint(f, keep_marker=True)
    return None if r is None else r[0]


def _read_size(f):
    r = _read_vint(f, keep_marker=False)
    return None if r is None else r[0]


def _read_uint(data: bytes) -> int:
    v = 0
    for b in data:
        v = (v << 8) | b
    return v


class WebmReader:
    """Iterate video frames of a .webm file: yields (payload, pts_ns)."""

    def __init__(self, path_or_file):
        if hasattr(path_or_file, "read"):
            self._f = path_or_file
            self._own = False
        else:
            self._f = open(path_or_file, "rb")
            self._own = True
        self.codec_id = None        # "V_VP9" / "V_VP8"
        self.width = 0
        self.height = 0
        self.timecode_scale = 1000000  # ns per timecode tick (default)
        self._video_track = None
        self._clusters = []          # (offset, size)
        self._parse_headers()

    # ------------------------------------------------------------ header

    def _parse_headers(self):
        f = self._f
        eid = _read_id(f)
        if eid != _EBML:
            raise ValueError("not an EBML/WebM file")
        sz = _read_size(f)
        f.seek(sz, io.SEEK_CUR)
        eid = _read_id(f)
        if eid != _SEGMENT:
            raise ValueError("missing Segment")
        seg_size = _read_size(f)
        seg_start = f.tell()
        end = seg_start + seg_size if seg_size != (1 << 56) - 1 else None
        while True:
            pos = f.tell()
            if end is not None and pos >= end:
                break
            eid = _read_id(f)
            if eid is None:
                break
            sz = _read_size(f)
            if sz is None:
                break
            body_at = f.tell()
            if eid == _INFO:
                self._parse_info(f.read(sz))
            elif eid == _TRACKS:
                self._parse_tracks(f.read(sz))
            elif eid == _CLUSTER:
                self._clusters.append((body_at, sz))
                f.seek(sz, io.SEEK_CUR)
            else:
                f.seek(sz, io.SEEK_CUR)

    def _parse_info(self, data: bytes):
        f = io.BytesIO(data)
        while True:
            eid = _read_id(f)
            if eid is None:
                break
            sz = _read_size(f)
            body = f.read(sz)
            if eid == _TIMECODE_SCALE:
                self.timecode_scale = _read_uint(body)

    def _parse_tracks(self, data: bytes):
        f = io.BytesIO(data)
        while True:
            eid = _read_id(f)
            if eid is None:
                break
            sz = _read_size(f)
            body = f.read(sz)
            if eid == _TRACK_ENTRY:
                self._parse_track_entry(body)

    def _parse_track_entry(self, data: bytes):
        f = io.BytesIO(data)
        num = None
        ttype = None
        codec = None
        w = h = 0
        while True:
            eid = _read_id(f)
            if eid is None:
                break
            sz = _read_size(f)
            body = f.read(sz)
            if eid == _TRACK_NUMBER:
                num = _read_uint(body)
            elif eid == _TRACK_TYPE:
                ttype = _read_uint(body)
            elif eid == _CODEC_ID:
                codec = body.decode("ascii", "replace").rstrip("\x00")
            elif eid == _VIDEO:
                g = io.BytesIO(body)
                while True:
                    vid = _read_id(g)
                    if vid is None:
                        break
                    vsz = _read_size(g)
                    vbody = g.read(vsz)
                    if vid == _PIXEL_WIDTH:
                        w = _read_uint(vbody)
                    elif vid == _PIXEL_HEIGHT:
                        h = _read_uint(vbody)
        if ttype == _TRACK_TYPE_VIDEO and self._video_track is None:
            self._video_track = num
            self.codec_id = codec
            self.width = w
            self.height = h

    # ------------------------------------------------------------ frames

    def __iter__(self) -> Iterator[Tuple[bytes, int]]:
        f = self._f
        for off, sz in self._clusters:
            f.seek(off)
            data = f.read(sz)
            yield from self._iter_cluster(data)

    def _iter_cluster(self, data: bytes):
        f = io.BytesIO(data)
        cluster_tc = 0
        while True:
            eid = _read_id(f)
            if eid is None:
                break
            sz = _read_size(f)
            body = f.read(sz)
            if eid == _CLUSTER_TIMECODE:
                cluster_tc = _read_uint(body)
            elif eid == _SIMPLE_BLOCK:
                yield from self._iter_block(body, cluster_tc)
            elif eid == _BLOCK_GROUP:
                g = io.BytesIO(body)
                while True:
                    gid = _read_id(g)
                    if gid is None:
                        break
                    gsz = _read_size(g)
                    gbody = g.read(gsz)
                    if gid == _BLOCK:
                        yield from self._iter_block(gbody, cluster_tc)

    def _iter_block(self, data: bytes, cluster_tc: int):
        f = io.BytesIO(data)
        tr = _read_vint(f, keep_marker=False)
        if tr is None or tr[0] != self._video_track:
            return
        rel = int.from_bytes(f.read(2), "big", signed=True)
        flags = f.read(1)[0]
        lacing = (flags >> 1) & 3
        payload = f.read()
        pts = (cluster_tc + rel) * self.timecode_scale
        if lacing == 0:
            yield payload, pts
            return
        n = payload[0] + 1
        pos = 1
        sizes = []
        if lacing == 2:  # fixed
            each = (len(payload) - 1) // n
            sizes = [each] * n
        elif lacing == 1:  # Xiph
            for _ in range(n - 1):
                s = 0
                while True:
                    b = payload[pos]
                    pos += 1
                    s += b
                    if b != 255:
                        break
                sizes.append(s)
            sizes.append(len(payload) - pos - sum(sizes))
        else:  # EBML lacing
            g = io.BytesIO(payload[pos:])
            first = _read_vint(g, keep_marker=False)
            s = first[0]
            consumed = first[1]
            sizes.append(s)
            for _ in range(n - 2):
                d = _read_vint(g, keep_marker=False)
                # signed delta: range-shift by (2^(7*len-1) - 1)
                delta = d[0] - ((1 << (7 * d[1] - 1)) - 1)
                s += delta
                consumed += d[1]
                sizes.append(s)
            pos += consumed
            sizes.append(len(payload) - pos - sum(sizes))
        for s in sizes:
            yield payload[pos:pos + s], pts
            pos += s

    def close(self):
        if self._own:
            self._f.close()

    def __enter__(self):
        return self

    def __exit__(self, *a):
        self.close()


# ------------------------------------------------------------------ mux

def _enc_id(eid: int) -> bytes:
    n = (eid.bit_length() + 7) // 8
    return eid.to_bytes(n, "big")


def _enc_size(n: int) -> bytes:
    """EBML vint size with the length marker in the top bits."""
    for length in range(1, 9):
        if n < (1 << (7 * length)) - 1:
            return ((1 << (7 * length)) | n).to_bytes(length, "big")
    raise ValueError("size too large")


def _elem(eid: int, body: bytes) -> bytes:
    return _enc_id(eid) + _enc_size(len(body)) + body


def _enc_uint(v: int) -> bytes:
    n = max(1, (v.bit_length() + 7) // 8)
    return v.to_bytes(n, "big")


class WebmWriter:
    """Minimal WebM muxer for one VP8/VP9 video track (the reference's
    vpxenc --webm path via libwebm's mkvmuxer).  One Cluster per
    keyframe-led group; SimpleBlocks with relative timecodes."""

    _EBML_VERSION = 0x4286
    _EBML_READ_VERSION = 0x42F7
    _EBML_MAX_ID = 0x42F2
    _EBML_MAX_SIZE = 0x42F3
    _DOCTYPE = 0x4282
    _DOCTYPE_VERSION = 0x4287
    _DOCTYPE_READ_VERSION = 0x4285
    _MUXING_APP = 0x4D80
    _WRITING_APP = 0x5741
    _TRACK_UID = 0x73C5

    def __init__(self, f, codec: str, width: int, height: int,
                 fps_num: int = 30, fps_den: int = 1):
        assert codec in ("vp8", "vp9")
        self._f = f
        self._codec_id = b"V_VP9" if codec == "vp9" else b"V_VP8"
        self._w, self._h = width, height
        self._frame_ms = 1000.0 * fps_den / max(fps_num, 1)
        self._clusters: list[bytes] = []
        self._cur: list[bytes] = []     # current cluster's blocks
        self._cur_tc = 0                # current cluster abs timecode
        self._n = 0

    def write_frame(self, payload: bytes, frame_idx: int,
                    keyframe: bool) -> None:
        tc = int(round(frame_idx * self._frame_ms))
        if keyframe and self._cur:
            self._flush_cluster()
        if not self._cur:
            self._cur_tc = tc
        rel = tc - self._cur_tc
        if rel > 0x7FFF:                # relative timecode is int16
            self._flush_cluster()
            self._cur_tc = tc
            rel = 0
        blk = (b"\x81"                  # track 1 (vint)
               + rel.to_bytes(2, "big", signed=True)
               + bytes([0x80 if keyframe else 0x00]) + payload)
        self._cur.append(_elem(_SIMPLE_BLOCK, blk))
        self._n += 1

    def _flush_cluster(self):
        if not self._cur:
            return
        body = _elem(_CLUSTER_TIMECODE, _enc_uint(self._cur_tc)) \
            + b"".join(self._cur)
        self._clusters.append(_elem(_CLUSTER, body))
        self._cur = []

    def close(self) -> None:
        self._flush_cluster()
        ebml = _elem(_EBML, b"".join([
            _elem(self._EBML_VERSION, b"\x01"),
            _elem(self._EBML_READ_VERSION, b"\x01"),
            _elem(self._EBML_MAX_ID, b"\x04"),
            _elem(self._EBML_MAX_SIZE, b"\x08"),
            _elem(self._DOCTYPE, b"webm"),
            _elem(self._DOCTYPE_VERSION, b"\x02"),
            _elem(self._DOCTYPE_READ_VERSION, b"\x02")]))
        info = _elem(_INFO, b"".join([
            _elem(_TIMECODE_SCALE, _enc_uint(1000000)),
            _elem(self._MUXING_APP, b"cuda-vp9-tpu"),
            _elem(self._WRITING_APP, b"cuda-vp9-tpu")]))
        video = _elem(_VIDEO, _elem(_PIXEL_WIDTH, _enc_uint(self._w))
                      + _elem(_PIXEL_HEIGHT, _enc_uint(self._h)))
        track = _elem(_TRACK_ENTRY, b"".join([
            _elem(_TRACK_NUMBER, b"\x01"),
            _elem(self._TRACK_UID, b"\x01"),
            _elem(_TRACK_TYPE, b"\x01"),
            _elem(_CODEC_ID, self._codec_id),
            video]))
        tracks = _elem(_TRACKS, track)
        segment = _elem(_SEGMENT,
                        info + tracks + b"".join(self._clusters))
        self._f.write(ebml + segment)
