"""cuda_vp9_torch: the VP9 decoder's device side in PyTorch and CUDA.

The host side (IVF/WebM containers, the C++ parser and packer in
`cuda_vp9_tpu/native`, the oracle decoder, `runtime/{pack,plan,lfmeta}`
and `ops/ref`) is shared with the JAX package `cuda_vp9_tpu`, so both
backends step from the same flat int16 wire.  This package ports the
per-frame device step for 8-bit 4:2:0 streams (keyframes, intra-only and
inter frames, compound prediction, scaled references):

  ops/transforms.py       inverse DCT/ADST 4..32 (int16 WRAPLOW domain)
  ops/device/stages.py    intra wavefront: the 10 predictors + residual
  ops/cuda/loopfilter.py  loop filter: CUDA kernel (csrc/loopfilter.cu)
                          and its plain torch twin
  runtime/fused.py        one frame step: residual, MC, mask add, intra,
                          loop filter, pool refresh, output ring
  runtime/pipeline.py     TorchRecon, the NativeVp9Decoder recon backend
  convert.py              decoder state (pool, ring) into the port
  codec.py                vp9_dx_torch(device) for the vpx_codec_* API
  tools/vpxdec.py         `python -m cuda_vp9_torch.tools.vpxdec --md5`
  tools/profile_decode.py time per stage of the frame step

The package imports torch and never jax.
"""

import importlib.util
import sys

if importlib.util.find_spec("jax") is None:
    # No JAX on this machine: the shared host packer's three loop-filter
    # pack names come from the NumPy shim (see _hostshim's docstring).
    from . import _hostshim

    sys.modules.setdefault("cuda_vp9_tpu.ops.pallas.loopfilter", _hostshim)
