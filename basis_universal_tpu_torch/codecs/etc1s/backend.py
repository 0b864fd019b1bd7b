"""Copy of `basis_universal_tpu/codecs/etc1s/backend.py`.

ETC1S backend: entropy-code codebooks + slice streams into .basis sections.

Host-side serial layer (SURVEY.md §7 "entropy coding is irreducibly serial"):
device kernels hand over dense index arrays; this module turns them into the
bit-exact stream format consumed by decode_palettes/decode_tables/
transcode_slice (see codecs/etc1s/stream.py for the decode-side contract and
the reference citations; encoder behavior mirrors basisu_backend.cpp:77-1747).

Everything vectorizable is numpy (pred selection, delta symbols, palette
deltas); only the selector MTF-history simulation is a Python loop (it is
inherently sequential; a C++ extension replaces it when throughput demands).
"""

import numpy as np

from ...entropy.bitio import BitWriter
from ...entropy.huffman import HuffmanEncoder
from .stream import (
    ENDPOINT_PRED_COUNT_VLC_BITS,
    ENDPOINT_PRED_MIN_REPEAT_COUNT,
    ENDPOINT_PRED_REPEAT_LAST_SYMBOL,
    ENDPOINT_PRED_TOTAL_SYMBOLS,
    MAX_SELECTOR_HISTORY_BUF_SIZE,
    SELECTOR_HISTORY_BUF_RLE_COUNT_THRESH,
    SELECTOR_HISTORY_BUF_RLE_COUNT_TOTAL,
)


def sort_endpoint_palette(color5, inten5, block_endpoints):
    """Order the endpoint palette by usage locality; remap block indices.

    Greedy co-occurrence chaining (palette_index_reorderer analog,
    basisu_backend.cpp:197): entries whose blocks neighbor each other in
    raster order get adjacent palette indices, so the explicit
    delta-endpoint symbols concentrate near zero.
    """
    e = np.asarray(block_endpoints, dtype=np.int64).ravel()
    num = color5.shape[0]
    if num <= 2 or e.size < 2:
        order = np.arange(num)
    else:
        # sparse co-occurrence counts of consecutive distinct indices
        a, b = e[:-1], e[1:]
        m = a != b
        a, b = a[m], b[m]
        lo = np.minimum(a, b)
        hi = np.maximum(a, b)
        key = lo * num + hi
        uniq, cnt = np.unique(key, return_counts=True)
        pairs = np.empty((uniq.size, 3), dtype=np.int64)
        pairs[:, 0] = uniq // num
        pairs[:, 1] = uniq % num
        pairs[:, 2] = cnt
        usage = np.bincount(e, minlength=num).astype(np.int64)
        order = _cooccurrence_order(pairs, usage, num)
    inv = np.empty_like(order)
    inv[order] = np.arange(order.size)
    return color5[order], inten5[order], inv[np.asarray(block_endpoints)]


def sort_selector_palette(selectors, block_selectors):
    """Order selector patterns so adjacent entries differ in few BYTES
    (the palette is XOR-delta coded per byte row): greedy nearest-neighbor
    chain on byte-row hamming distance (optimize_selector_codebook analog)."""
    as_bytes = _selector_rows_to_bytes(selectors)             # (S,4) uint8
    s = as_bytes.shape[0]
    if s <= 2:
        order = np.arange(s)
    else:
        # distance = number of differing byte rows (drives XOR zero-runs)
        a32 = as_bytes.astype(np.uint32) @ np.array(
            [1, 1 << 8, 1 << 16, 1 << 24], dtype=np.uint32)
        order = _selector_chain(np.ascontiguousarray(a32))
    inv = np.empty_like(order)
    inv[order] = np.arange(order.size)
    return selectors[order], inv[np.asarray(block_selectors)]


def _selector_chain(a32: np.ndarray) -> np.ndarray:
    """Greedy chain on packed selector byte keys; native when available."""
    import ctypes

    from ... import native

    n = a32.shape[0]
    lib = native.get_lib()
    if lib is not None:
        out = np.zeros(n, dtype=np.int32)
        lib.selector_chain_order(
            a32.ctypes.data_as(ctypes.POINTER(ctypes.c_uint32)), n,
            out.ctypes.data_as(ctypes.POINTER(ctypes.c_int32)))
        return out.astype(np.int64)
    x = a32[:, None] ^ a32[None, :]
    d = (((x & np.uint32(0xFF)) != 0).astype(np.uint8)
         + ((x & np.uint32(0xFF00)) != 0)
         + ((x & np.uint32(0xFF0000)) != 0)
         + ((x >> np.uint32(24)) != 0))
    return _greedy_chain(np.ascontiguousarray(d, dtype=np.uint8))


def _greedy_chain(d: np.ndarray) -> np.ndarray:
    """Greedy nearest-neighbor chain; native when available."""
    import ctypes

    from ... import native

    n = d.shape[0]
    lib = native.get_lib()
    if lib is not None:
        out = np.zeros(n, dtype=np.int32)
        lib.greedy_chain_order(
            d.ctypes.data_as(ctypes.POINTER(ctypes.c_uint8)), n,
            out.ctypes.data_as(ctypes.POINTER(ctypes.c_int32)))
        return out.astype(np.int64)
    placed = np.zeros(n, dtype=bool)
    placed[0] = True
    order = [0]
    row = d[0].astype(np.int16)
    for _ in range(n - 1):
        row[placed] = 32767
        nxt = int(np.argmin(row))
        placed[nxt] = True
        order.append(nxt)
        row = d[nxt].astype(np.int16)
    return np.asarray(order)


def _cooccurrence_order(pairs: np.ndarray, usage: np.ndarray, n: int) -> np.ndarray:
    """Usage-locality greedy order; native when available."""
    import ctypes

    from ... import native

    lib = native.get_lib()
    if lib is not None:
        out = np.zeros(n, dtype=np.int32)
        lib.cooccurrence_order(
            np.ascontiguousarray(pairs).ctypes.data_as(ctypes.POINTER(ctypes.c_int64)),
            pairs.shape[0],
            np.ascontiguousarray(usage).ctypes.data_as(ctypes.POINTER(ctypes.c_int64)),
            n, out.ctypes.data_as(ctypes.POINTER(ctypes.c_int32)))
        return out.astype(np.int64)
    adj = [[] for _ in range(n)]
    for i, j, c in pairs:
        adj[int(i)].append((int(j), int(c)))
        adj[int(j)].append((int(i), int(c)))
    placed = np.zeros(n, dtype=bool)
    cur = int(np.argmax(usage))
    placed[cur] = True
    order = [cur]
    affinity = np.zeros(n, dtype=np.int64)
    for _ in range(n - 1):
        for j, c in adj[cur]:
            if not placed[j]:
                affinity[j] += c
        affinity[placed] = -1
        nxt = int(np.argmax(affinity))
        if affinity[nxt] <= 0:
            rem = np.flatnonzero(~placed)
            nxt = int(rem[np.argmax(usage[rem])])
        placed[nxt] = True
        order.append(nxt)
        affinity[nxt] = -1
        cur = nxt
    return np.asarray(order)


def _selector_rows_to_bytes(selectors):
    """(S,16) selector values (idx=y*4+x) → (S,4) packed bytes, row y per
    byte, x at bits 2x (decode_palettes bit layout)."""
    s = selectors.reshape(-1, 4, 4).astype(np.uint32)
    return (s[..., 0] | (s[..., 1] << 2) | (s[..., 2] << 4) | (s[..., 3] << 6)).astype(np.uint8)


def encode_endpoint_palette(color5, inten5) -> bytes:
    """Inverse of decode_palettes' endpoint section."""
    e = color5.shape[0]
    inten_prev = np.concatenate([[0], inten5[:-1].astype(np.int64)])
    inten_delta = (inten5.astype(np.int64) - inten_prev) & 7

    c = color5.astype(np.int64)                                # (E,3)
    prev = np.empty_like(c)
    prev[0] = 16
    prev[1:] = c[:-1]
    delta = (c - prev) & 31                                    # (E,3)
    model_sel = np.where(prev <= 9, 0, np.where(prev <= 21, 1, 2))

    freqs = [np.bincount(delta[model_sel == m], minlength=32) for m in range(3)]
    inten_freqs = np.bincount(inten_delta, minlength=8)
    # decode_palettes requires all four models valid (non-empty) — give
    # unused context models a dummy single-symbol code
    for f in freqs + [inten_freqs]:
        if not f.any():
            f[0] = 1
    enc_c = [HuffmanEncoder(f) for f in freqs]
    enc_i = HuffmanEncoder(inten_freqs)

    w = BitWriter()
    for m in range(3):
        enc_c[m].write_table(w)
    enc_i.write_table(w)
    w.put_bits(0, 1)  # not grayscale

    # interleave: per endpoint: inten sym, then r,g,b syms
    codes = np.empty((e, 4), dtype=np.uint64)
    lens = np.empty((e, 4), dtype=np.uint8)
    codes[:, 0] = enc_i.codes[inten_delta]
    lens[:, 0] = enc_i.lengths[inten_delta]
    for ch in range(3):
        for m in range(3):
            mask = model_sel[:, ch] == m
            codes[mask, 1 + ch] = enc_c[m].codes[delta[mask, ch]]
            lens[mask, 1 + ch] = enc_c[m].lengths[delta[mask, ch]]
    w.put_bits_array(codes.ravel(), lens.ravel())
    return w.to_bytes()


def encode_selector_palette(selectors) -> bytes:
    """Inverse of decode_palettes' selector section (XOR-delta coding)."""
    s = selectors.shape[0]
    rows = _selector_rows_to_bytes(selectors).astype(np.int64)  # (S,4)
    w = BitWriter()
    w.put_bits(0, 1)  # no global cb
    w.put_bits(0, 1)  # no hybrid cb
    if s == 1:
        w.put_bits(1, 1)  # raw
        w.put_bits_array(rows[0], np.full(4, 8))
        return w.to_bytes()
    delta = rows[1:] ^ rows[:-1]                               # (S-1,4)
    freqs = np.bincount(delta.ravel(), minlength=256)
    if not freqs.any():
        freqs[0] = 1
    enc = HuffmanEncoder(freqs)
    huff_cost = 14 + 8 * 4 + enc.cost_bits(delta.ravel()) + 400  # + table approx
    raw_cost = s * 32
    if raw_cost <= huff_cost:
        w.put_bits(1, 1)  # raw
        w.put_bits_array(rows.ravel(), np.full(rows.size, 8))
    else:
        w.put_bits(0, 1)
        enc.write_table(w)
        w.put_bits_array(rows[0], np.full(4, 8))
        w.put_bits_array(enc.codes[delta.ravel()], enc.lengths[delta.ravel()])
    return w.to_bytes()


def _compute_pred_symbols(e_idx, num_endpoints, s_idx=None,
                          prev_frame=None, is_video=False):
    """Vectorized per-block predictor selection + delta symbols.

    Decoder contract (transcode_slice): pred 0=left (prev raster block,
    bx>0), 1=upper, 2=upper-left (bx>0 and by>0) — or, for video P-frames,
    2=conditional replenishment (copy BOTH indices from the previous frame,
    no selector symbol read) — 3=explicit delta vs prev raster block.
    Returns (pred (BY,BX) int8, delta_sym (BY,BX) int32 valid where pred==3).
    """
    by, bx = e_idx.shape
    e = e_idx.astype(np.int64)
    left = np.zeros_like(e)
    left[:, 1:] = e[:, :-1]
    up = np.zeros_like(e)
    up[1:, :] = e[:-1, :]
    can_left = np.zeros(e.shape, dtype=bool)
    can_left[:, 1:] = True
    can_up = np.zeros(e.shape, dtype=bool)
    can_up[1:, :] = True

    pred = np.full(e.shape, 3, dtype=np.int8)
    cr_locked = np.zeros(e.shape, dtype=bool)
    if prev_frame is not None:
        # video P-frame: pred 2 replaces upper-left with CR; CR wins because
        # it encodes BOTH indices and skips the selector symbol entirely
        pe, ps = prev_frame
        cr = (e == pe.astype(np.int64)) & (np.asarray(s_idx) == ps)
        pred = np.where(cr, 2, pred)
        cr_locked = cr
    elif not is_video:
        # upper-left pred only exists outside video files (in video files
        # the decoder always interprets pred 2 as CR, even on I-frames)
        ul = np.zeros_like(e)
        ul[1:, 1:] = e[:-1, :-1]
        pred = np.where(can_left & can_up & (e == ul), 2, pred)
    pred = np.where(can_up & (e == up) & ~cr_locked, 1, pred)
    pred = np.where(can_left & (e == left) & ~cr_locked, 0, pred)

    flat = e.ravel()
    prev = np.concatenate([[0], flat[:-1]])
    delta = (flat - prev) % num_endpoints
    return pred, delta.reshape(by, bx).astype(np.int64)


def _pack_group_syms(pred):
    """Pack 2x2 per-block preds into group symbols (8-bit layout:
    bits[1:0]=(x,y)=(0,0), [3:2]=(1,0), [5:4]=(0,1), [7:6]=(1,1))."""
    by, bx = pred.shape
    gy, gx = (by + 1) // 2, (bx + 1) // 2
    p = np.zeros((gy * 2, gx * 2), dtype=np.int64)
    p[:by, :bx] = pred
    g = (p[0::2, 0::2]
         | (p[0::2, 1::2] << 2)
         | (p[1::2, 0::2] << 4)
         | (p[1::2, 1::2] << 6))
    return g  # (gy, gx)


class _MtfEncoder:
    """Exact encoder-side mirror of the decoder's ApproxMoveToFront
    (zero-initialized buffer, duplicates allowed, first-match find —
    basisu_transcoder_internal.h:863-925)."""

    def __init__(self, n):
        self.values = [0] * n
        self.rover = n // 2

    def find(self, v):
        try:
            return self.values.index(v)
        except ValueError:
            return -1

    def add(self, v):
        self.values[self.rover] = v
        self.rover += 1
        if self.rover == len(self.values):
            self.rover = len(self.values) // 2

    def use(self, index):
        if index:
            half = index // 2
            self.values[half], self.values[index] = (
                self.values[index], self.values[half])


def _collect_slice_symbols(e_idx, s_idx, num_endpoints, num_selectors,
                           prev_frame=None, is_video=False):
    """Serial symbol-collection pass for one slice.

    Returns an ordered op list [(kind, value)] where kind ∈
    {"pred", "pred_rle_vlc", "delta", "sel", "sel_rle", "sel_rle_vlc"}
    plus the frequency tables for the four models. prev_frame: optional
    (prev_e, prev_s) grids for video P-frames (CR prediction).
    """
    by, bx = e_idx.shape
    pred, delta = _compute_pred_symbols(e_idx, num_endpoints, s_idx,
                                        prev_frame, is_video)
    groups = _pack_group_syms(pred)

    SEL_RLE_SYM = num_selectors + MAX_SELECTOR_HISTORY_BUF_SIZE
    # per-block op lists: a selector RLE's symbols are read by the decoder at
    # the FIRST block of the run, after that block's pred/delta symbols —
    # buffering per block preserves the interleave when a run is closed later.
    nb = by * bx
    block_ops = [[] for _ in range(nb)]
    pred_freq = np.zeros(ENDPOINT_PRED_TOTAL_SYMBOLS, dtype=np.int64)
    delta_freq = np.zeros(num_endpoints, dtype=np.int64)
    sel_freq = np.zeros(num_selectors + MAX_SELECTOR_HISTORY_BUF_SIZE + 1, dtype=np.int64)
    rle_freq = np.zeros(SELECTOR_HISTORY_BUF_RLE_COUNT_TOTAL, dtype=np.int64)

    hist = _MtfEncoder(MAX_SELECTOR_HISTORY_BUF_SIZE)

    # endpoint-pred RLE state (runs over group raster order)
    prev_group_sym = -1
    group_repeat_left = 0   # how many upcoming groups are covered by an RLE
    gflat = groups.ravel()
    run_end = np.empty(gflat.size, dtype=np.int64)
    run_end[-1] = 1
    for k in range(gflat.size - 2, -1, -1):
        run_end[k] = run_end[k + 1] + 1 if gflat[k] == gflat[k + 1] else 1

    gx = groups.shape[1]

    # selector RLE pending run (selector == hist[0] repeats); blocks may be
    # non-contiguous in video (CR blocks read no selector symbol)
    pending_blocks = []

    def flush_sel_run():
        n = len(pending_blocks)
        if n == 0:
            return
        if n < SELECTOR_HISTORY_BUF_RLE_COUNT_THRESH:
            # short run: each block reads its own hist-index-0 symbol
            for b in pending_blocks:
                block_ops[b].append(("sel", num_selectors))
                sel_freq[num_selectors] += 1
        else:
            tgt = block_ops[pending_blocks[0]]
            tgt.append(("sel", SEL_RLE_SYM))
            sel_freq[SEL_RLE_SYM] += 1
            if n >= (SELECTOR_HISTORY_BUF_RLE_COUNT_TOTAL - 1
                     + SELECTOR_HISTORY_BUF_RLE_COUNT_THRESH):
                run_sym = SELECTOR_HISTORY_BUF_RLE_COUNT_TOTAL - 1
                tgt.append(("sel_rle", run_sym))
                rle_freq[run_sym] += 1
                tgt.append(("sel_rle_vlc", n - SELECTOR_HISTORY_BUF_RLE_COUNT_THRESH))
            else:
                run_sym = n - SELECTOR_HISTORY_BUF_RLE_COUNT_THRESH
                tgt.append(("sel_rle", run_sym))
                rle_freq[run_sym] += 1
        pending_blocks.clear()

    for y in range(by):
        for x in range(bx):
            bi = y * bx + x
            ops = block_ops[bi]
            if (x & 1) == 0 and (y & 1) == 0:
                gi = (y >> 1) * gx + (x >> 1)
                if group_repeat_left:
                    # decoder consumes no symbol here (repeat counter active)
                    group_repeat_left -= 1
                else:
                    sym = int(gflat[gi])
                    run = int(run_end[gi])
                    if sym == prev_group_sym and run >= ENDPOINT_PRED_MIN_REPEAT_COUNT:
                        # decoder: REPEAT read at THIS group → this group uses
                        # prev sym, counter = vlc + MIN-1 covers the next
                        # groups; total covered = vlc + MIN = run
                        ops.append(("pred", ENDPOINT_PRED_REPEAT_LAST_SYMBOL))
                        pred_freq[ENDPOINT_PRED_REPEAT_LAST_SYMBOL] += 1
                        ops.append(("pred_rle_vlc",
                                    run - ENDPOINT_PRED_MIN_REPEAT_COUNT))
                        group_repeat_left = run - 1
                    else:
                        ops.append(("pred", sym))
                        pred_freq[sym] += 1
                        prev_group_sym = sym

            if pred[y, x] == 3:
                d = int(delta[y, x])
                ops.append(("delta", d))
                delta_freq[d] += 1

            if prev_frame is not None and pred[y, x] == 2:
                # CR block: the decoder reads no selector symbol and leaves
                # the MTF history and any active RLE run untouched
                continue

            s = int(s_idx[y, x])
            hidx = hist.find(s)
            if hidx == 0:
                pending_blocks.append(bi)
                continue
            flush_sel_run()
            if hidx > 0:
                ops.append(("sel", num_selectors + hidx))
                sel_freq[num_selectors + hidx] += 1
                hist.use(hidx)
            else:
                ops.append(("sel", s))
                sel_freq[s] += 1
                hist.add(s)
    flush_sel_run()

    flat_ops = [op for ops in block_ops for op in ops]
    kinds = np.array([_OP_KIND_ID[k] for k, _ in flat_ops], dtype=np.int32)
    vals = np.array([v for _, v in flat_ops], dtype=np.int32)
    return kinds, vals, pred_freq, delta_freq, sel_freq, rle_freq


# op kind ids shared with native/slice_codec.cpp
_OP_KIND_ID = {"pred": 0, "delta": 1, "sel": 2, "sel_rle": 3,
               "pred_rle_vlc": 4, "sel_rle_vlc": 5}


def _collect_slice_symbols_native(e_idx, s_idx, num_endpoints, num_selectors):
    import ctypes

    from ... import native

    lib = native.get_lib()
    by, bx = e_idx.shape
    cap = 4 * by * bx + 64
    op_kind = np.zeros(cap, dtype=np.int32)
    op_val = np.zeros(cap, dtype=np.int32)
    pred_freq = np.zeros(ENDPOINT_PRED_TOTAL_SYMBOLS, dtype=np.int64)
    delta_freq = np.zeros(num_endpoints, dtype=np.int64)
    sel_freq = np.zeros(num_selectors + MAX_SELECTOR_HISTORY_BUF_SIZE + 1, dtype=np.int64)
    rle_freq = np.zeros(SELECTOR_HISTORY_BUF_RLE_COUNT_TOTAL, dtype=np.int64)
    e = np.ascontiguousarray(e_idx, dtype=np.int32)
    s = np.ascontiguousarray(s_idx, dtype=np.int32)

    def p(a, t):
        return a.ctypes.data_as(ctypes.POINTER(t))

    n = lib.etc1s_collect_slice_symbols(
        p(e, ctypes.c_int32), p(s, ctypes.c_int32), by, bx,
        num_endpoints, num_selectors,
        p(op_kind, ctypes.c_int32), p(op_val, ctypes.c_int32),
        p(pred_freq, ctypes.c_int64), p(delta_freq, ctypes.c_int64),
        p(sel_freq, ctypes.c_int64), p(rle_freq, ctypes.c_int64))
    return (op_kind[:n].copy(), op_val[:n].copy(),
            pred_freq, delta_freq, sel_freq, rle_freq)


def encode_slices_rdo(pixels_list, e_idx_list, s_idx_list,
                      color5, inten5, selectors,
                      e_thresh: float, s_thresh: float, comp_level: int,
                      perceptual: bool = True):
    """RDO backend pipeline (basisu_backend.cpp encode_image RDO analog).

    pixels_list: per-slice (B,16,3) uint8 source pixels.
    e_idx_list/s_idx_list: per-slice (BY,BX) int32 grids (frontend index
    space). color5 (E,3)/inten5 (E,)/selectors (S,16) uint8 codebooks.

    Runs the native two-pass RDO: pred substitution, explicit-sequence
    palette sort, delta remap, selector-history RDO. Returns
    (tables, slice_streams, e_color5, e_inten, sel_cb, e_grids, s_grids)
    with palettes in final (sorted, pruned) order and grids remapped.
    """
    import ctypes

    from ... import native
    from ...ops.etc1 import ETC1_INTEN_TABLES, color5_to_8

    lib = native.get_lib()
    assert lib is not None

    num_e = color5.shape[0]
    num_s = selectors.shape[0]
    pal_colors = np.clip(
        color5_to_8(color5.astype(np.int32))[:, None, :]
        + ETC1_INTEN_TABLES[inten5.astype(np.int32)][:, :, None],
        0, 255).astype(np.int32)                               # (E,4,3)

    def p(a, t):
        return a.ctypes.data_as(ctypes.POINTER(t))

    # ---- pass A: pred selection + endpoint substitution (old index space)
    preds, refs, expl = [], [], []
    e_grids = [np.ascontiguousarray(e, dtype=np.int32).copy()
               for e in e_idx_list]
    s_grids = [np.ascontiguousarray(s, dtype=np.int32).copy()
               for s in s_idx_list]
    pal_c = np.ascontiguousarray(pal_colors)
    for px, e_g, s_g in zip(pixels_list, e_grids, s_grids):
        by, bx = e_g.shape
        pxc = np.ascontiguousarray(px, dtype=np.uint8)
        sel_pat = np.ascontiguousarray(
            selectors[s_g.ravel()], dtype=np.uint8)            # (B,16)
        pred = np.zeros(by * bx, dtype=np.uint8)
        ref = np.zeros(by * bx, dtype=np.uint8)
        seq = np.zeros(by * bx, dtype=np.int32)
        n = lib.etc1s_rdo_pred_pass(
            p(e_g, ctypes.c_int32), by, bx,
            p(pxc, ctypes.c_uint8), p(sel_pat, ctypes.c_uint8),
            p(pal_c, ctypes.c_int32), num_e, float(e_thresh),
            p(pred, ctypes.c_uint8), p(ref, ctypes.c_uint8),
            p(seq, ctypes.c_int32), int(bool(perceptual)))
        preds.append(pred)
        refs.append(ref)
        expl.append(seq[:n])

    # ---- endpoint palette sort over the EXPLICIT symbol sequence
    # (reference sorts with palette_index_reorderer over all_endpoint_indices,
    # basisu_backend.cpp:195-197) — entries adjacent in the explicit stream
    # get adjacent indices so explicit deltas concentrate near zero.
    used = np.zeros(num_e, dtype=bool)
    for e_g in e_grids:
        used[np.unique(e_g)] = True
    pair_src = []
    usage = np.zeros(num_e, dtype=np.int64)
    for seq in expl:
        if seq.size:
            usage += np.bincount(seq, minlength=num_e)
        if seq.size >= 2:
            a, b = seq[:-1], seq[1:]
            m = a != b
            pair_src.append(np.stack([a[m], b[m]], axis=1))
    if pair_src and used.sum() > 2:
        ab = np.concatenate(pair_src, axis=0).astype(np.int64)
        lo = np.minimum(ab[:, 0], ab[:, 1])
        hi = np.maximum(ab[:, 0], ab[:, 1])
        key = lo * num_e + hi
        uniq, cnt = np.unique(key, return_counts=True)
        pairs = np.stack([uniq // num_e, uniq % num_e, cnt], axis=1)
        order = _cooccurrence_order(pairs, usage, num_e)
    else:
        order = np.arange(num_e)
    # unused entries last, then pruned
    order = np.asarray(sorted(order, key=lambda i: not used[i]))
    n_used = int(used.sum())
    inv = np.empty(num_e, dtype=np.int64)
    inv[order] = np.arange(num_e)
    e_color5 = color5[order[:n_used]]
    e_inten = inten5[order[:n_used]]
    e_grids = [inv[e_g].astype(np.int32) for e_g in e_grids]

    # ---- selector palette sort (greedy byte-hamming chain, as the
    # reference's sort_selector_codebook TSP walk, basisu_backend.cpp:246)
    if num_s > 2:
        as_bytes = _selector_rows_to_bytes(selectors)
        a32 = as_bytes.astype(np.uint32) @ np.array(
            [1, 1 << 8, 1 << 16, 1 << 24], dtype=np.uint32)
        s_order = _selector_chain(np.ascontiguousarray(a32))
    else:
        s_order = np.arange(num_s)
    inv_s = np.empty(num_s, dtype=np.int64)
    inv_s[s_order] = np.arange(num_s)
    sel_cb = selectors[s_order]
    s_grids = [inv_s[s_g].astype(np.int32) for s_g in s_grids]

    # ---- pass B: symbols with delta remap + selector history RDO
    pal_colors_new = np.ascontiguousarray(np.clip(
        color5_to_8(e_color5.astype(np.int32))[:, None, :]
        + ETC1_INTEN_TABLES[e_inten.astype(np.int32)][:, :, None],
        0, 255).astype(np.int32))
    c5_new = np.ascontiguousarray(e_color5, dtype=np.uint8)
    in_new = np.ascontiguousarray(e_inten, dtype=np.uint8)
    pat_new = np.ascontiguousarray(sel_cb, dtype=np.uint8)

    all_ops = []
    pred_freq = np.zeros(ENDPOINT_PRED_TOTAL_SYMBOLS, dtype=np.int64)
    delta_freq = np.zeros(n_used, dtype=np.int64)
    sel_freq = np.zeros(num_s + MAX_SELECTOR_HISTORY_BUF_SIZE + 1, dtype=np.int64)
    rle_freq = np.zeros(SELECTOR_HISTORY_BUF_RLE_COUNT_TOTAL, dtype=np.int64)
    for px, e_g, s_g, pred, ref in zip(pixels_list, e_grids, s_grids,
                                       preds, refs):
        by, bx = e_g.shape
        e_flat = np.ascontiguousarray(e_g.ravel())
        s_flat = np.ascontiguousarray(s_g.ravel())
        pxc = np.ascontiguousarray(px, dtype=np.uint8)
        cap = 4 * by * bx + 64
        op_kind = np.zeros(cap, dtype=np.int32)
        op_val = np.zeros(cap, dtype=np.int32)
        n = lib.etc1s_rdo_collect_slice_symbols(
            p(e_flat, ctypes.c_int32), p(s_flat, ctypes.c_int32),
            p(pred, ctypes.c_uint8), p(ref, ctypes.c_uint8), by, bx,
            p(pxc, ctypes.c_uint8), p(pal_colors_new, ctypes.c_int32),
            p(c5_new, ctypes.c_uint8), p(in_new, ctypes.c_uint8),
            p(pat_new, ctypes.c_uint8),
            n_used, num_s, float(e_thresh), float(s_thresh), int(comp_level),
            p(op_kind, ctypes.c_int32), p(op_val, ctypes.c_int32),
            p(pred_freq, ctypes.c_int64), p(delta_freq, ctypes.c_int64),
            p(sel_freq, ctypes.c_int64), p(rle_freq, ctypes.c_int64),
            int(bool(perceptual)))
        all_ops.append((op_kind[:n].copy(), op_val[:n].copy()))
        e_g[:] = e_flat.reshape(by, bx)      # pass B remaps in place
        s_g[:] = s_flat.reshape(by, bx)

    for f in (pred_freq, delta_freq, sel_freq, rle_freq):
        if not f.any():
            f[0] = 1
    enc_pred = HuffmanEncoder(pred_freq)
    enc_delta = HuffmanEncoder(delta_freq)
    enc_sel = HuffmanEncoder(sel_freq)
    enc_rle = HuffmanEncoder(rle_freq)
    tw = BitWriter()
    enc_pred.write_table(tw)
    enc_delta.write_table(tw)
    enc_sel.write_table(tw)
    enc_rle.write_table(tw)
    tw.put_bits(MAX_SELECTOR_HISTORY_BUF_SIZE, 13)
    tables = tw.to_bytes()

    streams = []
    for kinds, vals in all_ops:
        data = _emit_slice_native(kinds, vals, enc_pred, enc_delta,
                                  enc_sel, enc_rle)
        streams.append(data if data else b"\0")
    return tables, streams, e_color5, e_inten, sel_cb, e_grids, s_grids


def encode_slices(e_idx_list, s_idx_list, num_endpoints, num_selectors,
                  video_prev=None):
    """Encode all slices; models are shared across slices (decode_tables is
    read once per file). Returns (tables_bytes, [slice_bytes...]).

    video_prev: optional list mapping each slice to the index of its
    previous-frame slice (None = I-frame / not video)."""
    from ... import native

    use_native = native.available()

    all_ops = []
    pred_freq = np.zeros(ENDPOINT_PRED_TOTAL_SYMBOLS, dtype=np.int64)
    delta_freq = np.zeros(num_endpoints, dtype=np.int64)
    sel_freq = np.zeros(num_selectors + MAX_SELECTOR_HISTORY_BUF_SIZE + 1, dtype=np.int64)
    rle_freq = np.zeros(SELECTOR_HISTORY_BUF_RLE_COUNT_TOTAL, dtype=np.int64)
    is_video = video_prev is not None
    for i, (e_idx, s_idx) in enumerate(zip(e_idx_list, s_idx_list)):
        prev = video_prev[i] if video_prev else None
        if is_video:
            pf_data = ((e_idx_list[prev], s_idx_list[prev])
                       if prev is not None else None)
            kinds, vals, pf, df, sf, rf = _collect_slice_symbols(
                e_idx, s_idx, num_endpoints, num_selectors,
                prev_frame=pf_data, is_video=True)
        elif use_native:
            kinds, vals, pf, df, sf, rf = _collect_slice_symbols_native(
                e_idx, s_idx, num_endpoints, num_selectors)
        else:
            kinds, vals, pf, df, sf, rf = _collect_slice_symbols(
                e_idx, s_idx, num_endpoints, num_selectors)
        all_ops.append((kinds, vals))
        pred_freq += pf
        delta_freq += df
        sel_freq += sf
        rle_freq += rf

    # Models must be non-empty (decode_tables rejects empty tables); ensure
    # at least one symbol has a code.
    for f in (pred_freq, delta_freq, sel_freq, rle_freq):
        if not f.any():
            f[0] = 1

    enc_pred = HuffmanEncoder(pred_freq)
    enc_delta = HuffmanEncoder(delta_freq)
    enc_sel = HuffmanEncoder(sel_freq)
    enc_rle = HuffmanEncoder(rle_freq)

    tw = BitWriter()
    enc_pred.write_table(tw)
    enc_delta.write_table(tw)
    enc_sel.write_table(tw)
    enc_rle.write_table(tw)
    tw.put_bits(MAX_SELECTOR_HISTORY_BUF_SIZE, 13)
    tables = tw.to_bytes()

    slices = []
    for kinds, vals in all_ops:
        if use_native:
            data = _emit_slice_native(
                kinds, vals, enc_pred, enc_delta, enc_sel, enc_rle)
        else:
            data = _emit_slice_py(
                kinds, vals, enc_pred, enc_delta, enc_sel, enc_rle)
        if not data:
            data = b"\0"  # decoder requires non-empty slice data
        slices.append(data)
    return tables, slices


def _emit_slice_py(kinds, vals, enc_pred, enc_delta, enc_sel, enc_rle):
    w = BitWriter()
    encs = [enc_pred, enc_delta, enc_sel, enc_rle]
    pend_v, pend_b = [], []
    for k, v in zip(kinds, vals):
        if k <= 3:
            enc = encs[k]
            pend_v.append(enc.codes[v])
            pend_b.append(enc.lengths[v])
        else:
            if pend_v:
                w.put_bits_array(np.array(pend_v, np.uint64),
                                 np.array(pend_b, np.uint8))
                pend_v, pend_b = [], []
            w.put_vlc(int(v), ENDPOINT_PRED_COUNT_VLC_BITS if k == 4 else 7)
    if pend_v:
        w.put_bits_array(np.array(pend_v, np.uint64), np.array(pend_b, np.uint8))
    return w.to_bytes()


def _emit_slice_native(kinds, vals, enc_pred, enc_delta, enc_sel, enc_rle):
    import ctypes

    from ... import native

    lib = native.get_lib()
    n = kinds.size
    cap = 4 * n + 64
    out = np.zeros(cap, dtype=np.uint8)

    def cp(enc):
        c = np.ascontiguousarray(enc.codes, dtype=np.uint32)
        l = np.ascontiguousarray(enc.lengths, dtype=np.uint8)
        return (c, l)

    arrs = [cp(e) for e in (enc_pred, enc_delta, enc_sel, enc_rle)]

    def p(a, t):
        return a.ctypes.data_as(ctypes.POINTER(t))

    args = [p(np.ascontiguousarray(kinds), ctypes.c_int32),
            p(np.ascontiguousarray(vals), ctypes.c_int32),
            ctypes.c_int64(n)]
    for c, l in arrs:
        args += [p(c, ctypes.c_uint32), p(l, ctypes.c_uint8)]
    args += [p(out, ctypes.c_uint8), ctypes.c_int64(cap)]
    nbytes = lib.etc1s_emit_slice_bits(*args)
    assert nbytes >= 0
    return out[:nbytes].tobytes()
