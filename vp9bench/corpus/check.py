"""Decode every stream of the named configurations through the program's
codec API on a device and hold each shown frame against its golden MD5.

    python3 -m vp9bench.corpus.check vp9_360p_vod vp9_2160p_vod \
        [--device cuda]

Prints one line a stream: frames, frames whose MD5 differs, frames the
program sent to its host oracle, its kernel launches and plain-twin calls,
and the seconds of the decode (the first stream's include the build or
load of the kernels).  Exits 1 if any frame differs.
"""

from __future__ import annotations

import argparse
import json
import sys
import time

from ..reference import frame_md5
from . import BENCH, load


def check(cfg: dict, device: str) -> int:
    from cuda_vp9_torch import codec
    from ..drivers import _kernel_modules
    bad_total = 0
    for st in load(cfg):
        mods = _kernel_modules()
        l0 = sum(m.launches for m in mods)
        p0 = sum(m.plain_calls for m in mods)
        ctx = codec.CodecCtx()
        threads = cfg.get("decoder", {}).get("threads", 1)
        if codec.vpx_codec_dec_init(ctx, codec.vp9_dx_torch(device),
                                    codec.DecCfg(threads=threads)):
            raise RuntimeError(ctx.err_detail)
        t0 = time.perf_counter()
        md5 = []
        for pkt in st.packets:
            if codec.vpx_codec_decode(ctx, pkt):
                raise RuntimeError(ctx.err_detail)
            it = codec.FrameIter()
            while (img := codec.vpx_codec_get_frame(ctx, it)) is not None:
                md5.append(frame_md5(img.planes))
        secs = time.perf_counter() - t0
        bad = sum(a != b for a, b in zip(md5, st.md5)) + abs(len(md5)
                                                             - len(st.md5))
        bad_total += bad
        r = ctx._recon
        print(json.dumps({
            "stream": st.name, "frames": len(md5), "md5_mismatch": bad,
            "frames_decoded": len(st.facts["frames"]),
            "frames_on_device": r.frames_on_device,
            "frames_on_host": r.frames_on_host,
            "launches": sum(m.launches for m in mods) - l0,
            "plain_calls": sum(m.plain_calls for m in mods) - p0,
            "seconds": secs}), flush=True)
        codec.vpx_codec_destroy(ctx)
    return bad_total


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("configs", nargs="+")
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(argv)
    bad = 0
    for name in args.configs:
        cfg = json.loads((BENCH / "configs" / f"{name}.json").read_text())
        bad += check(cfg, args.device)
    return 1 if bad else 0


if __name__ == "__main__":
    sys.exit(main())
