from .ivf import IvfReader, IvfWriter, is_ivf, is_vp8
from .webm import WebmReader


def open_video(path):
    """Open an input by sniffing the container (vpxdec's file_is_ivf /
    file_is_webm detection): returns an iterator of (payload, pts) with
    .width/.height attributes."""
    with open(path, "rb") as f:
        magic = f.read(4)
    if magic == b"DKIF":
        return IvfReader(path)
    if magic == b"\x1a\x45\xdf\xa3":
        return WebmReader(path)
    raise ValueError(f"unrecognized container: {path}")
