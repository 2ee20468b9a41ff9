"""The port's VP9 decoder interface for the shared vpx_codec_* API.

`vp9_dx_torch(device)` is the counterpart of `cuda_vp9_tpu.codec.vp9_dx`:
pass it to `cuda_vp9_tpu.codec.vpx_codec_dec_init` and the context
decodes with the C++ host parser and `TorchRecon(device)`.
"""

from __future__ import annotations

import torch


class Vp9TorchIface:
    """vpx_codec_iface_t for the torch backend."""

    name = "cuda-vp9-torch VP9 Decoder"

    def __init__(self, device):
        self.device = torch.device(device)

    def make_decoder(self, cfg, use_device: bool):
        """(decoder, recon); the shared init always asks for the device,
        and this iface has no host-only mode."""
        from cuda_vp9_tpu.decoder.frame import NativeVp9Decoder

        from .runtime.pipeline import TorchRecon
        recon = TorchRecon(self.device)
        return NativeVp9Decoder(recon_fn=recon, threads=cfg.threads), recon


def vp9_dx_torch(device) -> Vp9TorchIface:
    """The VP9 decoder iface with reconstruction on `device`."""
    return Vp9TorchIface(device)
