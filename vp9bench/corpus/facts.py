"""Per-frame facts of a VP9 stream: what the bitstream fixes, whatever
decodes it.

Made once, when the corpus is made (`make_corpus.py`), and committed
beside each stream as `<stream>.json`; the benchmark's roofline byte
functions (`vp9bench/roofline.py`) read them and nothing else.  The mode
information comes from the port's C++ entropy parser (`NativeParser`),
which reads it and nothing more: no reconstruction runs.  The shown
frame count is held against the two oracle decoders' when the corpus is
made.

Per frame, in decode order (a superframe's hidden alt-ref frame first):

  packet, shown, show_existing, type ("key", "inter", "intra_only"),
  lf_level, bytes (of the frame's payload), and per plane (Y, U, V):
  intra_4x4, inter_4x4   4x4 units predicted intra and inter (visible);
  compound_4x4           the inter units with two references;
  subpel_4x4             the inter units with a sub-pel vector (in x or
                         y, on either reference);
  intra_edges            [transform blocks, above samples, left samples,
                         corners]: the neighbours an intra transform
                         block reads, where the spec makes them available
                         (above: the block's width, from its row above
                         when there is one; left: its height, from the
                         column to its left inside the tile; the corner
                         when both are there).  The above-right run is
                         left out: it is not read where unavailable.
  mc_reads               {"WxH": [n, n_x, n_y, n_xy]}: reference blocks
                         read, by the predicted size (clipped to the
                         frame) and by whether the vector is sub-pel in
                         neither axis, x only, y only or both.  A
                         compound unit reads two.  Sub-8x8 luma reads one
                         block per distinct vector (4x4: four; 4x8, 8x4:
                         two); their chroma one 4x4 with the averaged
                         vector.  Vectors are taken as coded, before the
                         decoder clamps them to the frame's border.
"""

from __future__ import annotations

from collections import defaultdict

from ..ivf import read_ivf, superframe_spans

BLOCK_4X4, BLOCK_4X8, BLOCK_8X4, BLOCK_8X8 = 0, 1, 2, 3


def _round_q4(v: int) -> int:
    """round_mv_comp_q4 (vp9_reconinter.h): C division, toward 0."""
    v = v - 2 if v < 0 else v + 2
    return -((-v) // 4) if v < 0 else v // 4


def _uv_tx(bw4: int, bh4: int, tx: int) -> int:
    """The 4:2:0 chroma transform size of a block of bw4 x bh4 luma 4x4
    units with luma transform tx: the largest square transform inside the
    chroma block, and no larger than tx (uv_txsize_lookup)."""
    side = max(1, min(bw4, bh4) >> 1)          # chroma side in 4x4 units
    fit = {1: 0, 2: 1, 4: 2, 8: 3}[min(side, 8)]
    return min(tx, fit)


def _tile_starts(mi_cols: int, log2_cols: int):
    sb_cols = (mi_cols + 7) >> 3
    return [((i * sb_cols) >> log2_cols) << 3 for i in range(1 << log2_cols)]


def frame_facts(plan) -> dict:
    """The facts of one parsed frame (plan: the parser's FramePlan)."""
    hdr, mi = plan.hdr, plan.mi
    if (hdr.subsampling_x, hdr.subsampling_y) != (1, 1):
        raise ValueError("the corpus is 4:2:0")
    rows, cols = mi.mi_rows, mi.mi_cols
    starts = _tile_starts(cols, hdr.log2_tile_cols)
    pw4 = [(hdr.width + 3) >> 2, (hdr.width + 7) >> 3, (hdr.width + 7) >> 3]
    ph4 = [(hdr.height + 3) >> 2, (hdr.height + 7) >> 3,
           (hdr.height + 7) >> 3]
    intra4, inter4, comp4, sub4 = [0] * 3, [0] * 3, [0] * 3, [0] * 3
    edges = [[0, 0, 0, 0] for _ in range(3)]
    reads = [defaultdict(lambda: [0, 0, 0, 0]) for _ in range(3)]
    ref, mv, bmi = mi.ref, mi.mv, mi.bmi_mv
    for r, c, bsize, bwl, bhl in plan.blocks_arr.tolist():
        inter = ref[r, c, 0] > 0
        nref = 2 if ref[r, c, 1] > 0 else 1
        tile0 = max(s for s in starts if s <= c)
        for p in range(3):
            s = 1 if p else 0
            bx4, by4 = (c * 2) >> s, (r * 2) >> s
            n4w, n4h = max(1, (1 << bwl) >> s), max(1, (1 << bhl) >> s)
            vw, vh = min(n4w, pw4[p] - bx4), min(n4h, ph4[p] - by4)
            if vw <= 0 or vh <= 0:
                continue
            units = vw * vh
            if not inter:
                intra4[p] += units
                tx = int(mi.tx_size[r, c])
                if p:
                    tx = _uv_tx(1 << bwl, 1 << bhl, tx)
                step = 1 << tx
                for row in range(0, vh, step):
                    for col in range(0, vw, step):
                        up = row > 0 or r > 0
                        left = col > 0 or c > tile0
                        e = edges[p]
                        e[0] += 1
                        e[1] += 4 * min(step, vw - col) if up else 0
                        e[2] += 4 * min(step, vh - row) if left else 0
                        e[3] += 1 if up and left else 0
                continue
            inter4[p] += units
            if nref == 2:
                comp4[p] += units
            fmask = 15 if p else 7
            blocks = []          # (w px, h px, mv row, mv col)
            for k in range(nref):
                if bsize >= BLOCK_8X8:
                    m = mv[r, c, k]
                    blocks.append((4 * vw, 4 * vh, int(m[0]), int(m[1])))
                elif p == 0:
                    idx, w, h = {BLOCK_4X4: ((0, 1, 2, 3), 4, 4),
                                 BLOCK_4X8: ((0, 1), 4, 8),
                                 BLOCK_8X4: ((0, 2), 8, 4)}[bsize]
                    for i in idx:
                        m = bmi[r, c, i, k]
                        blocks.append((w, h, int(m[0]), int(m[1])))
                else:
                    sr = sum(int(bmi[r, c, i, k, 0]) for i in range(4))
                    sc = sum(int(bmi[r, c, i, k, 1]) for i in range(4))
                    blocks.append((4, 4, _round_q4(sr), _round_q4(sc)))
            any_sub = False
            for w, h, my, mx in blocks:
                fx, fy = (mx & fmask) != 0, (my & fmask) != 0
                reads[p][f"{w}x{h}"][fx + 2 * fy] += 1
                any_sub |= fx or fy
            if any_sub:
                sub4[p] += units
    ftype = ("key" if hdr.frame_type == 0 else
             "intra_only" if hdr.intra_only else "inter")
    return {"shown": int(bool(hdr.show_frame)), "show_existing": 0,
            "type": ftype, "lf_level": int(hdr.lf.filter_level),
            "intra_4x4": intra4, "inter_4x4": inter4,
            "compound_4x4": comp4, "subpel_4x4": sub4,
            "intra_edges": edges,
            "mc_reads": [dict(sorted(d.items())) for d in reads]}


def stream_facts(ivf_path: str, cfg: dict) -> dict:
    """The facts of every frame of an IVF stream."""
    from cuda_vp9_torch.native import NativeParser, ShowExisting
    width, height, packets = read_ivf(ivf_path)
    parser = NativeParser()
    frames = []
    for pi, packet in enumerate(packets):
        for off, size in superframe_spans(packet):
            plan = parser.parse(packet[off:off + size])
            if isinstance(plan, ShowExisting):
                f = {"shown": 1, "show_existing": 1, "type": "show_existing",
                     "lf_level": 0}
            else:
                f = frame_facts(plan)
            frames.append({"packet": pi, "bytes": size, **f})
    return {"config": cfg["name"], "width": width, "height": height,
            "bit_depth": cfg["bit_depth"], "packets": len(packets),
            "bytes": sum(len(p) for p in packets), "frames": frames}
