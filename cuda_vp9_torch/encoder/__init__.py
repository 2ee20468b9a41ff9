"""VP9 encoder (SURVEY S19, first slice).

Intra-only fixed-QP keyframe encoder producing spec-valid VP9 streams:
`Vp9Encoder.encode_frame` returns one keyframe payload; pair with
`containers.ivf.IvfWriter` for .ivf output (tools/vpxenc.py CLI).

Reference surface: vp9/encoder/vp9_bitstream.c (header + token packing),
vp9_dct.c (forward transforms), vp9_quantize.c, vp9_cx_iface.c.
"""

from .encoder import Vp9Encoder  # noqa: F401
