"""cuda_vp9_torch: the VP9 decoder with its device side in PyTorch and CUDA.

The package keeps its own copy of the host side of the JAX package
`cuda_vp9_tpu` that this path needs (IVF/WebM readers, the C++ parser
and packer in `native/`, the frame driver and headers in `decoder/`,
`models/`, the NumPy oracle in `ops/ref`,
`runtime/{pack,plan,lfmeta}`, `utils/md5`), so it reads the same flat
int16 wire as the JAX step, and it ports the per-frame device step for
bit depths 8, 10 and 12 and chroma 4:2:0, 4:4:4, 4:2:2 and 4:4:0
(keyframes, intra-only and inter frames, compound prediction, scaled
references):

  ops/transforms.py       inverse DCT/ADST 4..32 (int16 and int32 WRAPLOW)
  ops/device/stages.py    intra wavefront: the 10 predictors + residual
  ops/device/lf_wave.py   4:2:2 and 4:4:0 chroma loop filter in luma-SB
                          tile order
  ops/cuda/loopfilter.py  loop filter: CUDA kernel (csrc/loopfilter.cu)
                          and its plain torch twin
  ops/cuda/tileprobe.py   shared-memory tile probe: CUDA kernel
                          (csrc/tileprobe.cu) and its plain torch twin
  runtime/fused.py        one frame step: residual, MC, mask add, intra,
                          loop filter, pool refresh, output ring
  runtime/pipeline.py     TorchRecon, the NativeVp9Decoder recon backend
  runtime/multistream.py  many streams on one device (batched, round-robin)
  parallel/               many streams over several devices: one worker
                          process per device (ShardedBatchedDecoder)
  convert.py              decoder state (pool, ring) into the port
  codec/                  vp9_dx_torch(device) and the vpx_codec_* API
  tools/vpxdec.py         `python -m cuda_vp9_torch.tools.vpxdec --md5`
  tools/profile_decode.py time per stage of the frame step
  tools/tile_probe.py     the tile probe on the card
  tools/metrics.py        PSNR, SSIM, FastSSIM, PSNR-HVS as torch ops on a
                          device (and tools/tiny_ssim.py)

The encode side is host NumPy, as the reference's encoder runs on the
CPU: `encoder/` (Vp9Encoder, Vp9SvcEncoder), `vp8/encoder.py`
(Vp8Encoder), `containers/y4m.py` and `IvfWriter`, `tools/vpxenc.py` and
`tools/vp9_spatial_svc_encoder.py`; its symbol contexts come from the
Python parse helpers in `decoder/` (tiles, decodemv, mvref, detokenize,
compressed_header), while every stream the port decodes is parsed by
`native/`.

The package imports torch and never jax or cuda_vp9_tpu.  The C++ host
library and the CUDA kernels are built at first use into
`build/cuda_vp9_torch/` at the checkout root.
"""
