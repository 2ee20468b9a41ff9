"""Drive the program under test, `cuda_vp9_torch`, through its public
entry points, one packet or one round at a time.

A driver feeds its playlists (`traffic.playlists`), reads the planes of
each shown frame into host numpy arrays, and returns them as `Delivered`
records.  Each records every packet it feeds (`fed`, in order) and, from
`counters()`, what the program counts: kernel launches, plain-twin calls,
the uploader's bytes, frames on the device and on the host, batched
steps.  The traffic's `driver` names the class:

  "batched"    `runtime.multistream.BatchedTorchDecoder(slots, device)`:
               `decode_round` with one packet a slot, `drain()` every
               `drain_every` rounds;
  "codec_api"  `codec.vpx_codec_dec_init(ctx, vp9_dx_torch(device),
               DecCfg(threads))`, `vpx_codec_decode` a packet at a time,
               `vpx_codec_get_frame`, and each frame's planes read
               `read_lag` frames after its packet.

`fault` plants a fault for the checks of `correct` (never in a measured
run): "skip_loop_filter" turns on the program's VP9_SET_SKIP_LOOP_FILTER
(the control: a decode that skips a stage the stream asks for);
"stale" hands out each slot's previous frame again, as a step that leaves
its state unchanged; "drop_half" feeds no packet to every second slot
while its frames stay due; "alter" changes one sample of the first frame
delivered after `arm()`.
"""

from __future__ import annotations

from collections import deque
from typing import List, NamedTuple

import numpy as np

from .traffic import Item, playlists, warmup_items

FAULTS = ("skip_loop_filter", "stale", "drop_half", "alter")


class Delivered(NamedTuple):
    slot: int
    item: Item
    planes: list


def _kernel_modules():
    from cuda_vp9_torch.ops.cuda import (intra, lf422, loopfilter, mc, pages,
                                         residual)
    return (pages, residual, mc, intra, loopfilter, lf422)


class _Driver:
    def __init__(self, cfg, traffic, streams, seed, device, fault=None):
        if fault is not None and fault not in FAULTS:
            raise ValueError(f"unknown fault {fault!r}")
        self.cfg, self.traffic, self.streams = cfg, traffic, streams
        self.seed, self.device, self.fault = seed, device, fault
        self.fed: List[Item] = []
        self._armed = False
        self._last = {}

    def arm(self):
        """From now on the planted fault, if any, acts on delivered frames."""
        self._armed = True

    def _deliver(self, slot, item, planes) -> Delivered:
        if self._armed and self.fault == "stale":
            prev = self._last.get(slot)
            self._last[slot] = planes
            if prev is not None:
                planes = prev
        elif self._armed and self.fault == "alter":
            planes = [p.copy() for p in planes]
            planes[0][0, 0] ^= 1
            self.fault = None
        return Delivered(slot, item, planes)

    def counters(self) -> dict:
        mods = _kernel_modules()
        up = self._uploader()
        return {"launches": sum(m.launches for m in mods),
                "plain_calls": sum(m.plain_calls for m in mods),
                "sent_bytes": up.sent_bytes, "dense_frames": up.dense_frames,
                **self._frame_counts()}


class BatchedDriver(_Driver):
    """BatchedTorchDecoder over `slots` playlists in lockstep."""

    def __init__(self, cfg, traffic, streams, seed, device, fault=None):
        super().__init__(cfg, traffic, streams, seed, device, fault)
        from cuda_vp9_torch.runtime.multistream import BatchedTorchDecoder
        self.slots = traffic["slots"]
        self.dec = BatchedTorchDecoder(self.slots, device)
        if fault == "skip_loop_filter":
            for d in self.dec.decs:
                d.skip_loop_filter = True
        self._lists = playlists(traffic, streams, seed)
        self._due = [deque() for _ in range(self.slots)]
        self._rounds = 0

    def _uploader(self):
        return self.dec.uploader

    def _frame_counts(self) -> dict:
        st = self.dec.stats()
        return {"frames_on_device": sum(s["device"] for s in st),
                "frames_on_host": sum(s["host"] for s in st),
                "frames_unbatched": sum(s["unbatched"] for s in st),
                "rounds": self.dec.rounds, "slots": self.slots}

    def warm_up(self) -> List[Delivered]:
        out = []
        for _ in range(self.traffic["warmup_rounds"]):
            out += self.step()
        return out + self.drain()

    def step(self) -> List[Delivered]:
        """One round; every `drain_every` rounds, the drain's frames."""
        packets = []
        for s, it in enumerate(self._lists):
            item = next(it)
            self.fed.append(item)
            self._due[s].append(item)
            drop = (self.fault == "drop_half" and self._armed and s % 2)
            packets.append(None if drop
                           else self.streams[item.stream].packets[item.packet])
        self.dec.decode_round(packets)
        self._rounds += 1
        if self._rounds % self.traffic["drain_every"]:
            return []
        return self.drain()

    @property
    def at_boundary(self) -> bool:
        return self._rounds % self.traffic["drain_every"] == 0

    def drain(self) -> List[Delivered]:
        out = []
        for s, frame in self.dec.drain():
            out.append(self._deliver(s, self._due[s].popleft(),
                                     frame.visible_planes()))
        return out

    def finish(self) -> List[Delivered]:
        return self.drain()

    def due_left(self) -> int:
        return sum(len(q) for q in self._due)


class CodecApiDriver(_Driver):
    """One stream through the VP9 codec API, its frames read
    `read_lag` frames behind the decode."""

    def __init__(self, cfg, traffic, streams, seed, device, fault=None):
        super().__init__(cfg, traffic, streams, seed, device, fault)
        from cuda_vp9_torch import codec
        self.codec = codec
        if traffic["slots"] != 1:
            raise ValueError("a codec_api cell decodes one stream")
        self.ctx = codec.CodecCtx()
        threads = cfg.get("decoder", {}).get("threads", 1)
        err = codec.vpx_codec_dec_init(self.ctx, codec.vp9_dx_torch(device),
                                       codec.DecCfg(threads=threads))
        if err:
            raise RuntimeError(f"vpx_codec_dec_init: {self.ctx.err_detail}")
        if fault == "skip_loop_filter":
            codec.vpx_codec_control(self.ctx, codec.VP9_SET_SKIP_LOOP_FILTER,
                                    1)
        self._list = playlists(traffic, streams, seed)[0]
        self._lag = traffic["read_lag"]
        self._q = deque()         # (item, image) decoded, not yet read

    def _uploader(self):
        return self.ctx._recon.uploader

    def _frame_counts(self) -> dict:
        r = self.ctx._recon
        return {"frames_on_device": r.frames_on_device,
                "frames_on_host": r.frames_on_host}

    def _feed(self, item: Item):
        self.fed.append(item)
        c = self.codec
        if c.vpx_codec_decode(self.ctx, self.streams[item.stream]
                              .packets[item.packet]):
            raise RuntimeError(f"vpx_codec_decode: {self.ctx.err_detail}")
        it = c.FrameIter()
        shown = 0
        while (img := c.vpx_codec_get_frame(self.ctx, it)) is not None:
            self._q.append((item, img))
            shown += 1
        if shown != 1:
            raise RuntimeError(f"packet {item} gave {shown} frames")

    def _read(self, keep: int) -> List[Delivered]:
        out = []
        while len(self._q) > keep:
            item, img = self._q.popleft()
            out.append(self._deliver(0, item, [np.asarray(p) for p in
                                               img.planes]))
        return out

    def warm_up(self) -> List[Delivered]:
        """Each stream's first packets (every shape the cell decodes),
        read at once; then the playlist until the read lag is full."""
        out = []
        for item in warmup_items(self.traffic, self.streams, self.seed):
            self._feed(item)
        out += self._read(0)
        for _ in range(self._lag):
            self._feed(next(self._list))
        return out

    def step(self) -> List[Delivered]:
        self._feed(next(self._list))
        return self._read(self._lag)

    at_boundary = True

    def finish(self) -> List[Delivered]:
        return self._read(0)

    def due_left(self) -> int:
        return len(self._q)


DRIVERS = {"batched": BatchedDriver, "codec_api": CodecApiDriver}
