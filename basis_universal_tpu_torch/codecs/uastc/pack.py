"""UASTC LDR 4x4 block packing: mode sets, endpoint LUTs, the packers and
the LZ-aware selector RDO, and the packing on the device.

The numpy half is a copy of the host half of `basis_universal_tpu/codecs/
uastc/encode.py` (that module imports jax at the top, and the port must run
where jax is not installed): `_pack_from_compact` and its packers, which the
tests hold to the reference's bytes. The tables and the decoder are this
package's copies (`tables.py`, `decode.py`). `codecs/uastc/encode.py` of
this package is the mode search, in PyTorch.

The encoder packs on the search's device: `uastc_pack` writes the (B, 16)
blocks from the search's (B, 59) winner buffer, from one int32 table buffer
per slot list (`pack_tables`). A CUDA tensor launches the kernel of
`csrc/uastc_pack_kernels.cu`, a CPU tensor runs `pack_reference`, the same
field sequence in PyTorch; both give `_pack_from_compact`'s bytes.
"""

import functools

import numpy as np
import torch

from ...ops.cuda_etc1s import LAUNCHES, _check, _raise_on, _same_device, \
    _stream
from ...ops.etc1 import ETC1_INTEN_TABLES
from . import tables as T

# (mode, weight_bits, endpoint_range, comps)
RGB_MODES = [(0, 4, 19, 3), (1, 2, 20, 3), (5, 3, 20, 3), (18, 5, 11, 3)]
RGBA_MODES = [(10, 4, 13, 4), (12, 3, 19, 4), (14, 2, 20, 4)]
LA_MODES = [(15, 4, 20, 2)]

ALL_MODES = RGB_MODES + RGBA_MODES + LA_MODES


@functools.lru_cache(maxsize=None)
def quant_luts(ep_range: int):
    """(inverse LUT target→code, forward LUT code→unquantized) as numpy."""
    unq = T.color_unquant_table(ep_range).astype(np.int32)
    targets = np.arange(256)
    inv = np.argmin(np.abs(unq[None, :] - targets[:, None]), axis=1).astype(np.int32)
    return inv, unq


def _mode7_seeds():
    return [seed for (_bc7, seed, _i) in T.BC7_3_ASTC2_COMMON_PARTITIONS]


# --- ETC1 hint computation (cheap): one ETC1S fit per block -----------------

@functools.lru_cache(maxsize=None)
def _solid_etc1_luts():
    """(err, base5) tables indexed [inten*4+sel, target 0..255]."""
    inten = ETC1_INTEN_TABLES  # (8,4)
    base5 = np.arange(32)
    base8 = (base5 << 3) | (base5 >> 2)
    errs = np.zeros((32, 256), dtype=np.int32)
    bests = np.zeros((32, 256), dtype=np.int32)
    for i in range(8):
        for s in range(4):
            vals = np.clip(base8 + inten[i, s], 0, 255)      # (32,)
            t = np.arange(256)
            d = np.abs(vals[None, :] - t[:, None])
            bests[i * 4 + s] = np.argmin(d, axis=1)
            errs[i * 4 + s] = np.min(d, axis=1)
    return errs, bests


def _solid_hints(rgb):
    """Best (inten, selector, base555) for solid blocks (pack_etc1_block_
    solid_color analog, encoder/basisu_etc.h:1110). rgb: (N,3) int."""
    errs, bests = _solid_etc1_luts()
    e = (errs[:, rgb[:, 0]].astype(np.int64) ** 2
         + errs[:, rgb[:, 1]].astype(np.int64) ** 2
         + errs[:, rgb[:, 2]].astype(np.int64) ** 2)         # (32,N)
    combo = np.argmin(e, axis=0)                             # (N,)
    inten, sel = combo >> 2, combo & 3
    base = np.stack([bests[combo, rgb[:, c]] for c in range(3)], -1)
    return inten, sel, base


def _effort_mode_set(effort: int, has_alpha: bool):
    modes = list(RGB_MODES)
    if has_alpha:
        modes += RGBA_MODES + LA_MODES
    if effort <= 1:
        modes = [m for m in modes if m[0] in (0, 10, 15)]
    ls_iters = 1 if effort <= 2 else 2
    extra = ()
    if effort >= 2:
        extra = ("mode2", "mode4", "mode6")
        if has_alpha:
            # dual-plane alpha modes are essential at the default level:
            # uncorrelated alpha (edges/ramps over flat RGB) is only exactly
            # representable with a separate alpha weight plane
            extra += ("mode9", "mode11", "mode13", "mode17")
    if effort >= 3:
        extra += ("mode7", "mode3")
        if has_alpha and effort >= 4:
            extra += ("mode16",)
    return tuple(modes), ls_iters, extra, (4 if effort < 3 else 8)


def _pack_from_compact(compact: np.ndarray, px_rgba: np.ndarray,
                       modes: tuple, extra: tuple) -> np.ndarray:
    """Pack UASTC blocks from the device's compact winner buffer (B,59)."""
    b = compact.shape[0]
    best = compact[:, 0].astype(np.int32)
    ep = compact[:, 1:25].astype(np.int64)
    ws = compact[:, 25:57].astype(np.int64)
    aux = compact[:, 57].astype(np.int64)
    etc1_inten = compact[:, 58].astype(np.int32)

    out = np.zeros((b, 16), dtype=np.uint8)
    solid_slot = len(modes)
    solid_idx = np.flatnonzero(best == solid_slot)
    if solid_idx.size:
        out[solid_idx] = _pack_solid(ep[solid_idx, :3].astype(np.int32),
                                     px_rgba[solid_idx, 0, 3].astype(np.int32))
    for mi, (mode, wb, ep_range, comps) in enumerate(modes):
        idx = np.flatnonzero(best == mi)
        if not idx.size:
            continue
        out[idx] = _pack_mode(
            mode, wb, ep_range, comps,
            ep[idx, :comps * 2], ws[idx, :16], etc1_inten[idx])
    for xi, name in enumerate(extra):
        slot = solid_slot + 1 + xi
        idx = np.flatnonzero(best == slot)
        if not idx.size:
            continue
        ep_, w16, w32, aux_ = ep[idx], ws[idx, :16], ws[idx], aux[idx]
        if name == "mode2":
            out[idx] = _pack_mode_2subset(2, 3, 8, 3, ep_[:, :12], w16,
                                          aux_, etc1_inten[idx])
        elif name == "mode4":
            out[idx] = _pack_mode_2subset(4, 2, 12, 3, ep_[:, :12], w16,
                                          aux_, etc1_inten[idx])
        elif name == "mode6":
            out[idx] = _pack_mode_dualplane(6, 2, 18, ep_[:, :6], w32,
                                            aux_, etc1_inten[idx])
        elif name == "mode9":
            out[idx] = _pack_mode_2subset(9, 2, 8, 4, ep_[:, :16], w16,
                                          aux_, etc1_inten[idx])
        elif name == "mode7":
            out[idx] = _pack_mode_2subset(7, 2, 12, 3, ep_[:, :12], w16,
                                          aux_, etc1_inten[idx])
        elif name == "mode16":
            out[idx] = _pack_mode_2subset(16, 2, 20, 2, ep_[:, :8], w16,
                                          aux_, etc1_inten[idx])
        elif name == "mode3":
            out[idx] = _pack_mode_3subset(ep_[:, :18], w16, aux_,
                                          etc1_inten[idx])
        elif name == "mode11":
            out[idx] = _pack_mode_dualplane(11, 2, 13, ep_[:, :8], w32,
                                            aux_, etc1_inten[idx], comps=4)
        elif name == "mode13":
            out[idx] = _pack_mode_dualplane(13, 1, 20, ep_[:, :8], w32,
                                            aux_, etc1_inten[idx], comps=4)
        elif name == "mode17":
            out[idx] = _pack_mode_dualplane(
                17, 2, 20, ep_[:, :4], w32,
                np.ones(len(idx), np.int64), etc1_inten[idx],
                comps=2, emit_ccs=False)
    return out


def _wr(lanes, ofs: int, vals, n: int):
    """Write n bits of vals at static offset into (N,2) uint64 lanes."""
    if n == 0:
        return ofs
    v = vals.astype(np.uint64) & np.uint64((1 << n) - 1)
    if ofs < 64:
        lanes[:, 0] |= v << np.uint64(ofs)
        if ofs + n > 64:
            lanes[:, 1] |= v >> np.uint64(64 - ofs)
    else:
        lanes[:, 1] |= v << np.uint64(ofs - 64)
    return ofs + n


def _lanes_to_bytes(lanes):
    return lanes.view(np.uint8).reshape(-1, 16)


def _pack_solid(rgb, alpha):
    n = rgb.shape[0]
    lanes = np.zeros((n, 2), dtype=np.uint64)
    code, size = T.MODE_HUFF_CODES[T.MODE_SOLID]
    ofs = _wr(lanes, 0, np.full(n, code), size)
    for c in range(3):
        ofs = _wr(lanes, ofs, rgb[:, c], 8)
    ofs = _wr(lanes, ofs, alpha, 8)
    inten, sel, base = _solid_hints(rgb)
    ofs = _wr(lanes, ofs, np.ones(n), 1)            # etc1 diff
    ofs = _wr(lanes, ofs, inten, 3)
    ofs = _wr(lanes, ofs, sel, 2)
    for c in range(3):
        ofs = _wr(lanes, ofs, base[:, c], 5)
    return _lanes_to_bytes(lanes)


def _pack_mode(mode, wb, ep_range, comps, eps, ws, etc1_inten):
    """Pack one single-subset, single-plane mode group."""
    n = eps.shape[0]
    eps = eps.copy()
    ws = ws.copy()
    lanes = np.zeros((n, 2), dtype=np.uint64)
    code, size = T.MODE_HUFF_CODES[mode]
    ofs = _wr(lanes, 0, np.full(n, code), size)

    # hints (zeros = valid conservative defaults; etc1 inten from quick fit)
    if T.MODE_HAS_BC1_HINT0[mode]:
        ofs = _wr(lanes, ofs, np.zeros(n), 1)
    if T.MODE_HAS_BC1_HINT1[mode]:
        ofs = _wr(lanes, ofs, np.zeros(n), 1)
    ofs = _wr(lanes, ofs, np.zeros(n), 1)            # flip
    ofs = _wr(lanes, ofs, np.ones(n), 1)             # diff
    ofs = _wr(lanes, ofs, etc1_inten, 3)             # inten0
    ofs = _wr(lanes, ofs, etc1_inten, 3)             # inten1
    if T.MODE_HAS_ETC1_BIAS[mode]:
        ofs = _wr(lanes, ofs, np.zeros(n), 5)
    if T.MODE_HAS_ALPHA[mode]:
        ofs = _wr(lanes, ofs, np.full(n, 0x10), 8)   # EAC mult=1 table=0

    # anchor texel 0: if weight MSB set, invert weights + swap endpoints
    flip = (ws[:, 0] >> (wb - 1)) & 1
    wmax = (1 << wb) - 1
    ws = np.where(flip[:, None] == 1, wmax - ws, ws)
    for c in range(comps):
        lo = eps[:, c * 2].copy()
        hi = eps[:, c * 2 + 1].copy()
        eps[:, c * 2] = np.where(flip == 1, hi, lo)
        eps[:, c * 2 + 1] = np.where(flip == 1, lo, hi)

    ofs = _emit_endpoints(lanes, ofs, eps, ep_range, comps * 2)

    # weights (single plane, anchor texel 0 gets wb-1 bits)
    for i in range(16):
        nb = wb - (1 if i == 0 else 0)
        ofs = _wr(lanes, ofs, ws[:, i], nb)
    assert ofs <= 128, (mode, ofs)
    return _lanes_to_bytes(lanes)


def _emit_endpoints(lanes, ofs, eps, ep_range, total_values):
    """UASTC endpoint emission: trit/quint bundles first (last truncated),
    then the raw bits of every value (pack_uastc layout)."""
    n = eps.shape[0]
    ep_bits, ep_trits, ep_quints = T.BISE_RANGE_TABLE[ep_range]
    if ep_trits or ep_quints:
        mul = 3 if ep_trits else 5
        bundle = 5 if ep_trits else 3
        tq = eps >> ep_bits
        i = 0
        while i < total_values:
            cnt = min(bundle, total_values - i)
            accum = np.zeros(n, dtype=np.int64)
            m = 1
            for k in range(cnt):
                accum += tq[:, i + k].astype(np.int64) * m
                m *= mul
            if cnt == bundle:
                nb = 8 if ep_trits else 7
            elif ep_trits:
                nb = {1: 2, 2: 4, 3: 5, 4: 7}[cnt]
            else:
                nb = {1: 3, 2: 5}[cnt]
            ofs = _wr(lanes, ofs, accum, nb)
            i += cnt
    for i in range(total_values):
        ofs = _wr(lanes, ofs, eps[:, i] & ((1 << ep_bits) - 1), ep_bits)
    return ofs


def _common_hints(lanes, ofs, mode, n, etc1_inten):
    if T.MODE_HAS_BC1_HINT0[mode]:
        ofs = _wr(lanes, ofs, np.zeros(n), 1)
    if T.MODE_HAS_BC1_HINT1[mode]:
        ofs = _wr(lanes, ofs, np.zeros(n), 1)
    ofs = _wr(lanes, ofs, np.zeros(n), 1)            # flip
    ofs = _wr(lanes, ofs, np.ones(n), 1)             # diff
    ofs = _wr(lanes, ofs, etc1_inten, 3)             # inten0
    ofs = _wr(lanes, ofs, etc1_inten, 3)             # inten1
    if T.MODE_HAS_ETC1_BIAS[mode]:
        ofs = _wr(lanes, ofs, np.zeros(n), 5)
    if T.MODE_HAS_ALPHA[mode]:
        ofs = _wr(lanes, ofs, np.full(n, 0x10), 8)   # EAC mult=1 table=0
    return ofs


def _pack_mode_2subset(mode, wb, ep_range, comps, eps, ws, patterns,
                       etc1_inten):
    """Pack a 2-subset mode group (modes 2/4/9/16): 5-bit common pattern,
    per-subset anchors with the MSB-invert trick."""
    n = eps.shape[0]
    eps = eps.copy()
    ws = ws.copy()
    lanes = np.zeros((n, 2), dtype=np.uint64)
    code, size = T.MODE_HUFF_CODES[mode]
    ofs = _wr(lanes, 0, np.full(n, code), size)
    ofs = _common_hints(lanes, ofs, mode, n, etc1_inten)
    ofs = _wr(lanes, ofs, patterns, 5)

    wmax = (1 << wb) - 1
    # per-block anchors from the pattern; invert subsets whose anchor MSB set
    if mode == 7:
        seeds = _mode7_seeds()
    else:
        seeds = [seed for (_b, seed, _i) in T.ASTC_BC7_COMMON_PARTITIONS2]
    pat_rows = np.array([T.partition_pattern(seed, 2) for seed in seeds],
                        dtype=np.int64)
    anchor_rows = np.array([T.pattern_anchors(seed, 2) for seed in seeds],
                           dtype=np.int64)
    pat = pat_rows[patterns]                          # (N,16)
    anchors = anchor_rows[patterns]                   # (N,2)
    for s in range(2):
        a_idx = anchors[:, s]
        a_w = ws[np.arange(n), a_idx]
        flip = (a_w >> (wb - 1)) & 1
        in_subset = pat == s
        ws = np.where((flip[:, None] == 1) & in_subset, wmax - ws, ws)
        base = s * comps * 2
        for c in range(comps):
            lo = eps[:, base + c * 2].copy()
            hi = eps[:, base + c * 2 + 1].copy()
            eps[:, base + c * 2] = np.where(flip == 1, hi, lo)
            eps[:, base + c * 2 + 1] = np.where(flip == 1, lo, hi)

    ofs = _emit_endpoints(lanes, ofs, eps, ep_range, comps * 2 * 2)
    # weights with per-subset anchors
    is_anchor = np.zeros((n, 16), dtype=bool)
    is_anchor[np.arange(n), anchors[:, 0]] = True
    is_anchor[np.arange(n), anchors[:, 1]] = True
    # anchors vary per block → emit per (block-group by pattern) for static
    # widths; simplest correct path: per distinct pattern value
    out = np.zeros((n, 16), dtype=np.uint8)
    done = np.zeros(n, dtype=bool)
    for pv in np.unique(patterns):
        gi = np.flatnonzero(patterns == pv)
        glanes = lanes[gi].copy()
        gofs = ofs
        a0, a1 = anchor_rows[pv]
        for i in range(16):
            nb = wb - (1 if i in (a0, a1) else 0)
            gofs = _wr(glanes, gofs, ws[gi, i], nb)
        assert gofs <= 128
        out[gi] = _lanes_to_bytes(glanes)
        done[gi] = True
    assert done.all()
    return out


def _pack_mode_3subset(eps, ws, patterns, etc1_inten):
    """Pack mode 3 (3 subsets, 4-bit pattern index, range-7 endpoints,
    2-bit weights with three per-subset anchors)."""
    mode, wb, ep_range, comps = 3, 2, 7, 3
    n = eps.shape[0]
    eps = eps.copy()
    ws = ws.copy()
    lanes = np.zeros((n, 2), dtype=np.uint64)
    code, size = T.MODE_HUFF_CODES[mode]
    ofs = _wr(lanes, 0, np.full(n, code), size)
    ofs = _common_hints(lanes, ofs, mode, n, etc1_inten)
    ofs = _wr(lanes, ofs, patterns, 4)

    wmax = (1 << wb) - 1
    seeds = [seed for (_b, seed, _i) in T.ASTC_BC7_COMMON_PARTITIONS3]
    pat_rows = np.array([T.partition_pattern(seed, 3) for seed in seeds],
                        dtype=np.int64)
    anchor_rows = np.array([T.pattern_anchors(seed, 3) for seed in seeds],
                           dtype=np.int64)
    pat = pat_rows[patterns]                          # (N,16)
    anchors = anchor_rows[patterns]                   # (N,3)
    for s in range(3):
        a_idx = anchors[:, s]
        a_w = ws[np.arange(n), a_idx]
        flip = (a_w >> (wb - 1)) & 1
        in_subset = pat == s
        ws = np.where((flip[:, None] == 1) & in_subset, wmax - ws, ws)
        base = s * comps * 2
        for c in range(comps):
            lo = eps[:, base + c * 2].copy()
            hi = eps[:, base + c * 2 + 1].copy()
            eps[:, base + c * 2] = np.where(flip == 1, hi, lo)
            eps[:, base + c * 2 + 1] = np.where(flip == 1, lo, hi)

    ofs = _emit_endpoints(lanes, ofs, eps, ep_range, comps * 2 * 3)
    out = np.zeros((n, 16), dtype=np.uint8)
    done = np.zeros(n, dtype=bool)
    for pv in np.unique(patterns):
        gi = np.flatnonzero(patterns == pv)
        glanes = lanes[gi].copy()
        gofs = ofs
        anch = set(int(a) for a in anchor_rows[pv])
        for i in range(16):
            nb = wb - (1 if i in anch else 0)
            gofs = _wr(glanes, gofs, ws[gi, i], nb)
        assert gofs <= 128, gofs
        out[gi] = _lanes_to_bytes(glanes)
        done[gi] = True
    assert done.all()
    return out


def _pack_mode_dualplane(mode, wb, ep_range, eps, ws, ccs, etc1_inten,
                         comps=3, emit_ccs=True):
    """Pack dual-plane modes (6 RGB, 11/13 RGBA, 17 LA): 2-bit CCS (fixed
    and not emitted for mode 17), interleaved plane weights, per-plane
    anchor MSB-invert with per-channel endpoint swaps."""
    n = eps.shape[0]
    eps = eps.copy()
    ws = ws.copy()
    lanes = np.zeros((n, 2), dtype=np.uint64)
    code, size = T.MODE_HUFF_CODES[mode]
    ofs = _wr(lanes, 0, np.full(n, code), size)
    ofs = _common_hints(lanes, ofs, mode, n, etc1_inten)
    if emit_ccs:
        ofs = _wr(lanes, ofs, ccs, 2)

    wmax = (1 << wb) - 1
    for plane in range(2):
        a_w = ws[:, plane]                           # anchor texel 0
        flip = (a_w >> (wb - 1)) & 1
        ws[:, plane::2] = np.where(flip[:, None] == 1,
                                   wmax - ws[:, plane::2], ws[:, plane::2])
        for c in range(comps):
            comp_plane = (np.asarray(ccs) == c).astype(np.int64)
            do = (flip == 1) & (comp_plane == plane)
            lo = eps[:, c * 2].copy()
            hi = eps[:, c * 2 + 1].copy()
            eps[:, c * 2] = np.where(do, hi, lo)
            eps[:, c * 2 + 1] = np.where(do, lo, hi)

    ofs = _emit_endpoints(lanes, ofs, eps, ep_range, comps * 2)
    # weights: 32 interleaved; texel 0's two weights are anchors (wb-1 bits)
    for i in range(32):
        nb = wb - (1 if i < 2 else 0)
        ofs = _wr(lanes, ofs, ws[:, i], nb)
    assert ofs <= 128, ofs
    return _lanes_to_bytes(lanes)


# --- the packing on the device: tables, plain version, kernel wrapper ------

# The table buffer of one slot list (`pack_tables`), int32 words:
# - a header: the slot count, the offset of the slot records, the offset of
#   the solid-colour LUT, the buffer's length;
# - SLOT_WORDS per slot, in the order of the winner buffer's slot column
#   (`_effort_mode_set`'s modes, the solid colour, then its extra modes);
# - PATTERN_WORDS per partition pattern: the 16 texels' subsets, 2 bits
#   each; which weights are anchors (wb - 1 bits), one bit per weight; the
#   anchor texel of each subset, 4 bits each. The single-subset record, the
#   dual-plane one (weights 0 and 1 anchors), then the lists of the 2-subset
#   modes, of mode 7 and of mode 3;
# - the solid-colour LUT of `_solid_etc1_luts`: [inten*4+sel, target] the
#   error | the 5-bit base << 16, 32 x 256 words, last.
KIND_SUBSETS, KIND_SOLID, KIND_DUAL = 0, 1, 2
SLOT_WORDS = 16
(S_KIND, S_MODE, S_WB, S_RANGE, S_EP_BITS, S_TRITS, S_QUINTS, S_COMPS,
 S_CODE, S_CODE_SIZE, S_FLAGS, S_PAT_OFS, S_PAT_COUNT, S_AUX_BITS, S_CCS,
 S_SUBSETS) = range(SLOT_WORDS)
# S_FLAGS: the hint fields a mode has
F_HINT0, F_HINT1, F_BIAS, F_ALPHA = 1, 2, 4, 8
# S_AUX_BITS: the bits of the aux column written after the hints (a 2-subset
# mode's pattern 5, mode 3's 4, a dual-plane ccs 2); S_CCS: a dual-plane
# mode's fixed ccs (mode 17: 1, not written), -1 where the aux column is it
HEADER_WORDS = 4
PATTERN_WORDS = 3
LUT_WORDS = 32 * 256
# the words before the LUT, which the kernel stages in shared memory
MAX_PREFIX_WORDS = 1024
# (mode, weight bits, endpoint range, comps) of each extra slot's name, as
# `_pack_from_compact` packs it
EXTRA_MODES = {name: (m, int(T.MODE_WEIGHT_BITS[m]),
                      int(T.MODE_ENDPOINT_RANGES[m]), int(T.MODE_COMPS[m]))
               for name, m in (("mode2", 2), ("mode4", 4), ("mode6", 6),
                               ("mode9", 9), ("mode7", 7), ("mode16", 16),
                               ("mode3", 3), ("mode11", 11), ("mode13", 13),
                               ("mode17", 17))}


def _pattern_record(labels, anchors, anchor_mask):
    word = 0
    for i, s in enumerate(labels):
        word |= int(s) << (2 * i)
    packed = 0
    for s, a in enumerate(anchors):
        packed |= int(a) << (4 * s)
    return [int(np.uint32(word).view(np.int32)), anchor_mask, packed]


@functools.lru_cache(maxsize=None)
def _pack_tables(modes: tuple, extra: tuple, device: str) -> torch.Tensor:
    slots = [(KIND_SUBSETS,) + m for m in modes] + [(KIND_SOLID,)] + [
        (KIND_DUAL if T.MODE_PLANES[EXTRA_MODES[n][0]] == 2 else KIND_SUBSETS,)
        + EXTRA_MODES[n] for n in extra]
    lists = {1: [[0] * 16]}                 # the single-subset "pattern"
    anchors = {1: [(0,)]}
    for key, seeds, n_sub in (
            (2, [sd for (_b, sd, _i) in T.ASTC_BC7_COMMON_PARTITIONS2], 2),
            (7, _mode7_seeds(), 2),
            (3, [sd for (_b, sd, _i) in T.ASTC_BC7_COMMON_PARTITIONS3], 3)):
        lists[key] = [T.partition_pattern(sd, n_sub) for sd in seeds]
        anchors[key] = [T.pattern_anchors(sd, n_sub) for sd in seeds]
    pat_ofs = HEADER_WORDS + SLOT_WORDS * len(slots)
    patterns, where = [], {}
    for key in (1, "dual", 2, 7, 3):
        where[key] = pat_ofs + len(patterns)
        if key == "dual":
            patterns += _pattern_record([0] * 16, (0,), 0b11)
            continue
        for lab, anc in zip(lists[key], anchors[key]):
            mask = 0
            for a in anc:
                mask |= 1 << a
            patterns += _pattern_record(lab, anc, mask)
    recs = []
    for slot in slots:
        rec = [0] * SLOT_WORDS
        rec[S_KIND] = slot[0]
        if slot[0] == KIND_SOLID:
            rec[S_MODE] = T.MODE_SOLID
            rec[S_CODE], rec[S_CODE_SIZE] = T.MODE_HUFF_CODES[T.MODE_SOLID]
            rec[S_PAT_OFS], rec[S_PAT_COUNT] = where[1], 1
            recs += rec
            continue
        _kind, mode, wb, ep_range, comps = slot
        n_sub = int(T.MODE_SUBSETS[mode]) if slot[0] == KIND_SUBSETS else 1
        key = {1: 1, 2: 7 if mode == 7 else 2, 3: 3}[n_sub] \
            if slot[0] == KIND_SUBSETS else "dual"
        rec[S_MODE], rec[S_WB], rec[S_RANGE], rec[S_COMPS] = (
            mode, wb, ep_range, comps)
        rec[S_EP_BITS], rec[S_TRITS], rec[S_QUINTS] = \
            T.BISE_RANGE_TABLE[ep_range]
        rec[S_CODE], rec[S_CODE_SIZE] = T.MODE_HUFF_CODES[mode]
        rec[S_FLAGS] = (F_HINT0 * int(T.MODE_HAS_BC1_HINT0[mode])
                        | F_HINT1 * int(T.MODE_HAS_BC1_HINT1[mode])
                        | F_BIAS * int(T.MODE_HAS_ETC1_BIAS[mode])
                        | F_ALPHA * int(T.MODE_HAS_ALPHA[mode]))
        rec[S_PAT_OFS] = where[key]
        rec[S_PAT_COUNT] = 1 if key in (1, "dual") else len(lists[key])
        rec[S_AUX_BITS] = {1: 0, 2: 5, 7: 5, 3: 4, "dual": 2}[key]
        rec[S_CCS] = -1
        if mode == 17:                       # fixed ccs 1, not written
            rec[S_AUX_BITS], rec[S_CCS] = 0, 1
        rec[S_SUBSETS] = n_sub
        recs += rec
    lut_ofs = pat_ofs + len(patterns)
    if lut_ofs > MAX_PREFIX_WORDS:
        raise ValueError(f"{len(slots)} slots: {lut_ofs} table words before "
                         f"the LUT, at most {MAX_PREFIX_WORDS}")
    errs, bests = _solid_etc1_luts()
    lut = (errs | (bests << 16)).reshape(-1)
    n_words = lut_ofs + LUT_WORDS
    head = [len(slots), HEADER_WORDS, lut_ofs, n_words]
    buf = np.array(head + recs + patterns, dtype=np.int64)
    return torch.as_tensor(np.concatenate([buf, lut]).astype(np.int32),
                           device=device)


def pack_tables(modes: tuple, extra: tuple, device="cpu") -> torch.Tensor:
    """The int32 table buffer (layout above) of the slot list that
    `_effort_mode_set` gives as (modes, extra), on `device`; built from
    `tables.py` once per slot list and device."""
    return _pack_tables(tuple(modes), tuple(extra), str(torch.device(device)))


# bits of a truncated trit / quint bundle of 0..5 / 0..3 values
_TRIT_BUNDLE_BITS = (0, 2, 4, 5, 7, 8)
_QUINT_BUNDLE_BITS = (0, 3, 5, 7)


def pack_reference(compact, alpha0, tables):
    """Plain version of `uastc_pack`, on any device: `_pack_from_compact`'s
    bytes from the same tables as the kernel. Each block's fields, in the
    kernel's order, are (value, width) columns, 0 wide where the block's slot
    has no such field; their offsets are the widths' running sum, and the
    fields are written into a (B, 128) bit matrix (bit i of the block is
    bit i % 8 of byte i // 8), folded into 16 bytes."""
    dev = compact.device
    b_n = compact.shape[0]
    if b_n == 0:
        return torch.empty((0, 16), dtype=torch.uint8, device=dev)
    tab = tables.to(torch.int64)
    n_slots, slots_ofs, lut_ofs = (int(v) for v in tables[:3].tolist())
    slots = tab[slots_ofs:slots_ofs + n_slots * SLOT_WORDS].reshape(
        n_slots, SLOT_WORDS)
    lut = tab[lut_ofs:lut_ofs + LUT_WORDS].reshape(32, 256)
    c = compact.to(torch.int64)
    slot = c[:, 0]
    known = slot < n_slots
    rec = slots[torch.where(known, slot, 0)]
    kind = torch.where(known, rec[:, S_KIND], -1)
    solid = (kind == KIND_SOLID).long()
    other = (known & (kind != KIND_SOLID)).long()
    dual = kind == KIND_DUAL
    aux, inten = c[:, 57], c[:, 58]
    vals, widths = [], []

    def field(v, w):
        vals.append(torch.as_tensor(v, device=dev).expand(b_n))
        widths.append(w)

    field(rec[:, S_CODE], known.long() * rec[:, S_CODE_SIZE])
    # the solid colour: RGBA, then the ETC1 hint of `_solid_hints`
    rgb = c[:, 1:4]
    err, base = lut & 0xFFFF, lut >> 16
    e = sum(err[:, rgb[:, ch]] ** 2 for ch in range(3))     # (32, B)
    combo = torch.argmin(e, 0)
    for ch in range(3):
        field(rgb[:, ch], 8 * solid)
    field(alpha0.to(torch.int64), 8 * solid)
    field(1, solid)
    field(combo >> 2, 3 * solid)
    field(combo & 3, 2 * solid)
    for ch in range(3):
        field(base[combo, rgb[:, ch]], 5 * solid)
    # every other slot: the hints, then the pattern index or the ccs
    flags = rec[:, S_FLAGS]
    field(0, other * (flags & F_HINT0 != 0))
    field(0, other * (flags & F_HINT1 != 0))
    field(0, other)                                          # flip
    field(1, other)                                          # diff
    field(inten, 3 * other)
    field(inten, 3 * other)
    field(0, 5 * other * (flags & F_BIAS != 0))
    field(0x10, 8 * other * (flags & F_ALPHA != 0))          # EAC
    field(aux, other * rec[:, S_AUX_BITS])

    # the anchor flips: a subset (a plane) whose anchor weight has its MSB
    # set has its weights inverted and its endpoint pairs swapped, in turn
    pat = rec[:, S_PAT_OFS] + PATTERN_WORDS * torch.minimum(
        aux, rec[:, S_PAT_COUNT] - 1)
    labels, anchor_mask, anchors = tab[pat], tab[pat + 1], tab[pat + 2]
    wb, comps = rec[:, S_WB], rec[:, S_COMPS]
    wmax = (1 << wb) - 1
    top = torch.clamp(wb - 1, min=0)
    w = c[:, 25:57].clone()
    ep = c[:, 1:25].clone()
    texel = torch.arange(32, device=dev)
    lab = (labels[:, None] >> (2 * texel[:16])) & 3
    lab = torch.cat([lab, torch.full_like(lab, -1)], 1)

    def swap(do, col):
        col = torch.clamp(torch.as_tensor(col, device=dev).expand(b_n), 0,
                          22)[:, None]
        lo, hi = ep.gather(1, col), ep.gather(1, col + 1)
        ep.scatter_(1, col, torch.where(do[:, None], hi, lo))
        ep.scatter_(1, col + 1, torch.where(do[:, None], lo, hi))

    for s in range(3):
        a = (anchors >> (4 * s)) & 15
        flip = ((kind == KIND_SUBSETS) & (s < rec[:, S_SUBSETS])
                & ((w.gather(1, a[:, None])[:, 0] >> top) & 1 == 1))
        w = torch.where(flip[:, None] & (lab == s), wmax[:, None] - w, w)
        for ch in range(4):
            swap(flip & (ch < comps), s * comps * 2 + 2 * ch)
    ccs = torch.where(rec[:, S_CCS] >= 0, rec[:, S_CCS], aux)
    for plane in range(2):
        flip = dual & ((w[:, plane] >> top) & 1 == 1)
        w = torch.where(flip[:, None] & (texel % 2 == plane), wmax[:, None] - w,
                        w)
        for ch in range(4):
            swap(flip & (ch < comps) & ((ccs == ch) == (plane == 1)), 2 * ch)

    # the endpoints: trit / quint bundles (the last truncated), then every
    # value's raw bits
    n_values = rec[:, S_SUBSETS] * comps * 2
    ep_bits, trits, quints = rec[:, S_EP_BITS], rec[:, S_TRITS], rec[:, S_QUINTS]
    tq = ep >> ep_bits[:, None]
    bundle = torch.where(trits > 0, 5, torch.where(quints > 0, 3, 0))
    mul = torch.where(trits > 0, 3, 5)
    bits_of = torch.where(
        trits[:, None] > 0, torch.as_tensor(_TRIT_BUNDLE_BITS, device=dev),
        torch.as_tensor(_QUINT_BUNDLE_BITS + (0, 0), device=dev))
    for k in range(8):
        start = k * bundle
        cnt = torch.clamp(torch.minimum(n_values - start, bundle), min=0)
        accum = torch.zeros_like(cnt)
        m = torch.ones_like(cnt)
        for i in range(5):
            v = tq.gather(1, torch.clamp(start + i, max=23)[:, None])[:, 0]
            accum = accum + torch.where(i < cnt, v * m, 0)
            m = m * mul
        field(accum, other * bits_of.gather(1, cnt[:, None])[:, 0])
    for i in range(24):
        field(ep[:, i], other * (i < n_values) * ep_bits)
    # the weights: 16 (32 interleaved in a dual-plane mode), an anchor's
    # wb - 1 bits wide
    n_weights = torch.where(dual, 32, 16)
    for i in range(32):
        field(w[:, i], other * (i < n_weights)
              * (wb - ((anchor_mask >> i) & 1)))

    v = torch.stack(vals, 1)
    n = torch.stack([torch.as_tensor(x, device=dev).expand(b_n).long()
                     for x in widths], 1)
    ofs = torch.cumsum(n, 1) - n
    j = torch.arange(8, device=dev)
    pos = ofs[..., None] + j
    ok = (j < n[..., None]) & (pos < 128)
    bit = (v[..., None] >> j) & 1
    bits = torch.zeros((b_n, 129), dtype=torch.int64, device=dev)
    bits.scatter_(1, torch.where(ok, pos, 128).reshape(b_n, -1),
                  torch.where(ok, bit, 0).reshape(b_n, -1))
    return (bits[:, :128].reshape(b_n, 16, 8) << j).sum(-1).to(torch.uint8)


def uastc_pack(compact, alpha0, tables):
    """The (B, 16) uint8 UASTC blocks of the search's (B, 59) uint8 winner
    buffer [slot | endpoint codes (24) | weights (32) | aux | ETC1 intensity],
    with alpha0 (B,) int32 the alpha of each block's pixel 0 (the solid
    colour's; its low 8 bits are written) and tables `pack_tables`' buffer
    of the search's slot list: `_pack_from_compact`'s bytes.

    A CUDA tensor launches `uastc_pack` (`csrc/uastc_pack_kernels.cu`), 8
    lanes a block (4 from 16,384 blocks on), each writing its share of the
    block's fields at their closed-form places, and counts the launch; a
    CPU tensor runs
    `pack_reference`. It replaces the numpy packing
    (`_pack_from_compact`), which no TPU kernel stood behind; it is bound
    by its bytes, 59 + 4 in and 16 out per block."""
    _check(compact, "compact", torch.uint8, (None, 59))
    _check(alpha0, "alpha0", torch.int32, (compact.shape[0],))
    _check(tables, "tables", torch.int32, (None,))
    dev = _same_device(compact, alpha0, tables)
    if dev.type == "cpu":
        return pack_reference(compact, alpha0, tables)
    b_n = compact.shape[0]
    out = torch.empty((b_n, 16), dtype=torch.uint8, device=dev)
    if b_n == 0:
        return out
    from ...ops._build import get_lib

    with torch.cuda.device(dev):
        status = get_lib("uastc_pack_kernels").uastc_pack(
            compact.data_ptr(), alpha0.data_ptr(), tables.data_ptr(),
            tables.numel(), out.data_ptr(), b_n, _stream(dev))
    LAUNCHES["uastc_pack"] += 1
    _raise_on(status, "uastc_pack")
    return out


# --- UASTC RDO: LZ-aware selector-bit-range matching ------------------------

# per-mode (first_selector_bit, total_selector_bits) — the weight region
# of the 128-bit block (encoder/basisu_uastc_enc.cpp:3729
# g_uastc_mode_selector_bits; spec constants of the UASTC layout)
SELECTOR_BITS = ((65, 63), (69, 31), (73, 46), (89, 29), (89, 30), (68, 47),
                 (66, 62), (89, 30), (0, 0), (97, 30), (65, 63), (66, 62),
                 (81, 47), (94, 30), (92, 31), (62, 63), (98, 30), (61, 62),
                 (49, 79))

_TDEFL_SMALL_DIST_EXTRA = [0, 0, 0, 0, 1, 1, 2, 2] + [3] * 8 + [4] * 16 \
    + [5] * 32 + [6] * 64 + [7] * 128 + [8] * 256
_TDEFL_LARGE_DIST_EXTRA = [0, 0, 9, 9] + [10] * 4 + [11] * 8 + [12] * 16 \
    + [13] * 32 + [14] * 64

_RDO_SKIP_RMS = 8.0
_RDO_MAX_RMS_RATIO = 10.0
_RDO_SMOOTH_STD = 18.0
_RDO_SMOOTH_SCALE = 10.0


def _match_cost_bits(dist: int) -> int:
    """tdefl-style LZ match cost estimate
    (encoder/basisu_uastc_enc.cpp:3775)."""
    cost = 7 + 5
    if dist < 512:
        cost += _TDEFL_SMALL_DIST_EXTRA[dist & 511]
    else:
        cost += _TDEFL_LARGE_DIST_EXTRA[min(dist, 32767) >> 8]
        while dist >= 32768:
            cost += 1
            dist >>= 1
    return cost


def rdo_selector_match(blocks: np.ndarray, px_rgba: np.ndarray,
                       lam: float, dict_size: int = 4096) -> np.ndarray:
    """Partial-bit-range RDO (uastc_rdo analog,
    encoder/basisu_uastc_enc.cpp:3824-4161): for each block, try splicing
    an earlier same-mode block's SELECTOR bits (weight region only —
    mode/endpoints/hints stay) so the LZ stage finds long byte matches,
    scored J = ms_err·smooth_scale + bits·lambda against a tdefl cost
    model with a selector-pattern history.

    The per-candidate error is a dense one-hot contraction: with the
    block's per-texel/per-level error table E (B,t,L) and candidate
    weight patterns as one-hots (C,t,L), all trial errors are one
    einsum — the matmul-shaped reformulation of the reference's
    per-candidate decode loop. Single-plane modes only (dual-plane
    splices couple two weight streams; those blocks keep their coding).
    """
    if lam <= 0.0:
        return blocks
    from .decode import decode_rgba, unpack_blocks

    blocks = np.ascontiguousarray(blocks, dtype=np.uint8).reshape(-1, 16)
    n = blocks.shape[0]
    if n < 2:
        return blocks
    u = unpack_blocks(blocks)
    dec = decode_rgba(blocks).reshape(n, 16, 4).astype(np.int64)
    px = px_rgba.reshape(n, 16, 4).astype(np.int64)
    base_err = ((dec - px) ** 2).sum(axis=(1, 2))
    base_ms = base_err / 64.0
    std = px[..., :4].astype(np.float64).std(axis=1).max(-1)       # (n,)
    yl = np.clip(std / _RDO_SMOOTH_STD, 0.0, 1.0) ** 2
    smooth_scale = _RDO_SMOOTH_SCALE + (1.0 - _RDO_SMOOTH_SCALE) * yl

    max_back = max(1, dict_size // 16)
    out = blocks.copy()
    sel_history = {}           # (mode, sel_bytes) -> last global index

    for mode in np.unique(u.mode):
        if mode == T.MODE_SOLID or int(T.MODE_PLANES[mode]) != 1:
            continue
        first_bit, nbits = SELECTOR_BITS[mode]
        if nbits == 0:
            continue
        idx = np.flatnonzero(u.mode == mode)
        g = len(idx)
        if g < 2:
            continue
        wb = int(T.MODE_WEIGHT_BITS[mode])
        L = 1 << wb
        wunq = T.weight_unquant_table(wb).astype(np.int64)         # (L,)

        # error table E[b, t, l]: block b's texel t decoded with weight
        # level l (fixed endpoints); UASTC LDR interpolation semantics
        subsets = int(T.MODE_SUBSETS[mode])
        comps = int(T.MODE_COMPS[mode])
        cem = int(T.MODE_CEM[mode])
        unq = T.color_unquant_table(int(T.MODE_ENDPOINT_RANGES[mode]))
        eps = unq[u.endpoints[idx, :comps * 2 * subsets]].astype(np.int64)
        eps = eps.reshape(g, subsets, comps, 2)
        lo8 = np.zeros((g, subsets, 4), dtype=np.int64)
        hi8 = np.zeros((g, subsets, 4), dtype=np.int64)
        if cem == 8:
            lo8[..., :3] = eps[..., :3, 0]
            hi8[..., :3] = eps[..., :3, 1]
            lo8[..., 3] = hi8[..., 3] = 255
        elif cem == 12:
            lo8[...] = eps[..., :4, 0]
            hi8[...] = eps[..., :4, 1]
        else:            # CEM 4 LA
            for c in range(3):
                lo8[..., c] = eps[..., 0, 0]
                hi8[..., c] = eps[..., 0, 1]
            lo8[..., 3] = eps[..., 1, 0]
            hi8[..., 3] = eps[..., 1, 1]
        if subsets == 1:
            pat = np.zeros((g, 16), dtype=np.int64)
        else:
            pat = np.zeros((g, 16), dtype=np.int64)
            for k, cp in enumerate(u.common_pattern[idx]):
                seed = T.mode_pattern_seed(mode, int(cp))
                pat[k] = T.partition_pattern(seed, subsets)
        rows = np.arange(g)[:, None]
        tlo = lo8[rows, pat]                                       # (g,16,4)
        thi = hi8[rows, pat]
        wlev = wunq[np.arange(L)]
        l16 = (tlo.astype(np.int64) << 8) | tlo
        h16 = (thi.astype(np.int64) << 8) | thi
        rec = ((l16[:, :, None, :] * (64 - wlev)[None, None, :, None]
                + h16[:, :, None, :] * wlev[None, None, :, None] + 32)
               >> 6) >> 8                                          # (g,16,L,4)
        diff = rec - px[idx][:, :, None, :]
        E = (diff * diff).sum(-1).astype(np.float32)               # (g,16,L)

        wsel = u.weights[idx, :16].astype(np.int64)                # (g,16)
        onehot = np.zeros((g, 16, L), dtype=np.float32)
        np.put_along_axis(onehot, wsel[..., None], 1.0, axis=2)

        sel_bytes = [None] * g
        for k in range(g):
            bits = int.from_bytes(bytes(blocks[idx[k]]), "little")
            sel_bytes[k] = (bits >> first_bit) & ((1 << nbits) - 1)

        # LZ match-cost LUT over block distances (the tdefl estimate is a
        # step function of byte distance)
        dist_lut = np.array([_match_cost_bits(max(d, 1) * 16)
                             for d in range(max_back + 2)],
                            dtype=np.float32)

        CH = 512
        rms = np.sqrt(base_ms[idx])
        scale_g = smooth_scale[idx]
        for s0 in range(0, g, CH):
            s1 = min(s0 + CH, g)
            c0 = max(0, s0 - max_back)
            errs = np.einsum("btl,ctl->bc", E[s0:s1],
                             onehot[c0:s1]) / 64.0                  # (B,C)
            kk = np.arange(s0, s1)
            cc = np.arange(c0, s1)
            dist = idx[kk][:, None] - idx[cc][None, :]              # blocks
            valid = (cc[None, :] < kk[:, None]) & (dist <= max_back)
            bits_c = dist_lut[np.clip(dist, 0, max_back + 1)]
            t_mat = errs * scale_g[kk][:, None] + bits_c * float(lam)
            ratio_ok = errs <= (base_ms[idx[kk]]
                                * _RDO_MAX_RMS_RATIO ** 2)[:, None]
            t_mat = np.where(valid & ratio_ok, t_mat, np.inf)
            best_c_rel = t_mat.argmin(1)
            best_t_cand = t_mat[np.arange(s1 - s0), best_c_rel]
            for k in range(s0, s1):
                i_glob = int(idx[k])
                key = (int(mode), sel_bytes[k])
                if rms[k] >= _RDO_SKIP_RMS:
                    sel_history[key] = i_glob
                    continue
                prev = sel_history.get(key)
                cur_bits = nbits if prev is None \
                    else _match_cost_bits((i_glob - prev) * 16)
                cur_t = base_ms[i_glob] * scale_g[k] + cur_bits * lam
                if best_t_cand[k - s0] < cur_t:
                    c = int(best_c_rel[k - s0]) + c0
                    spliced = int.from_bytes(bytes(out[i_glob]), "little")
                    spliced &= ~(((1 << nbits) - 1) << first_bit)
                    spliced |= sel_bytes[c] << first_bit
                    out[i_glob] = np.frombuffer(
                        spliced.to_bytes(16, "little"), np.uint8)
                    sel_bytes[k] = sel_bytes[c]
                sel_history[(int(mode), sel_bytes[k])] = i_glob
        del E, onehot

    # endpoint refinement on every modified block (the reference's
    # m_endpoint_refinement, on by default): endpoints are LZ literals, so
    # re-fitting them to the spliced weights recovers error at no rate cost
    changed = np.flatnonzero((out != blocks).any(1))
    if changed.size:
        _refine_spliced_endpoints(out, changed, u, px)
    return out


def _refine_spliced_endpoints(out: np.ndarray, changed: np.ndarray,
                              u, px: np.ndarray) -> None:
    """LS-refit the endpoint fields of modified single-subset single-plane
    CEM 8/12 blocks in place, keeping mode/hints/weights bits untouched."""
    from .decode import unpack_blocks

    u2 = unpack_blocks(out[changed])
    for mode in np.unique(u2.mode):
        if mode == T.MODE_SOLID or int(T.MODE_SUBSETS[mode]) != 1 \
                or int(T.MODE_PLANES[mode]) != 1:
            continue
        cem = int(T.MODE_CEM[mode])
        if cem not in (8, 12):
            continue
        sel = np.flatnonzero(u2.mode == mode)
        gi = changed[sel]
        comps = int(T.MODE_COMPS[mode])
        wb = int(T.MODE_WEIGHT_BITS[mode])
        ep_range = int(T.MODE_ENDPOINT_RANGES[mode])
        wunq = T.weight_unquant_table(wb).astype(np.float64)
        uu = wunq[u2.weights[sel, :16]]                        # (m,16) 0..64
        a = (64.0 - uu) / 64.0
        bb = uu / 64.0
        A = (a * a).sum(1)
        Bm = (a * bb).sum(1)
        C = (bb * bb).sum(1)
        det = A * C - Bm * Bm
        ok = np.abs(det) > 1e-6
        det = np.where(ok, det, 1.0)
        v = px[gi, :, :comps].astype(np.float64)               # (m,16,comps)
        P = np.einsum("mi,mic->mc", a, v)
        Q = np.einsum("mi,mic->mc", bb, v)
        lo = np.clip((C[:, None] * P - Bm[:, None] * Q) / det[:, None],
                     0, 255)
        hi = np.clip((A[:, None] * Q - Bm[:, None] * P) / det[:, None],
                     0, 255)
        inv, unq = quant_luts(ep_range)
        lo_q = inv[np.round(lo).astype(np.int64)]
        hi_q = inv[np.round(hi).astype(np.int64)]

        # old vs new reconstruction error; keep refits that help
        old_eps = u2.endpoints[sel, :comps * 2].astype(np.int64)
        def rec_err(lo_c, hi_c):
            lo_u = unq[lo_c].astype(np.float64)                # (m,comps)
            hi_u = unq[hi_c].astype(np.float64)
            rec = (lo_u[:, None, :] * a[..., None]
                   + hi_u[:, None, :] * bb[..., None])
            return ((np.round(rec) - v) ** 2).sum(axis=(1, 2))
        err_old = rec_err(old_eps[:, 0::2], old_eps[:, 1::2])
        err_new = rec_err(lo_q, hi_q)
        better = ok & (err_new < err_old)
        if not better.any():
            continue

        # rebuild the endpoint field bits and splice them in place
        eps = np.zeros((int(better.sum()), comps * 2), dtype=np.int64)
        eps[:, 0::2] = lo_q[better]
        eps[:, 1::2] = hi_q[better]
        scratch = np.zeros((eps.shape[0], 2), dtype=np.uint64)
        nbits_ep = _emit_endpoints(scratch, 0, eps, ep_range, comps * 2)
        # endpoint field offset: huffman code + hint fields
        code, size = T.MODE_HUFF_CODES[mode]
        ofs = size
        ofs += int(T.MODE_HAS_BC1_HINT0[mode]) + int(T.MODE_HAS_BC1_HINT1[mode])
        ofs += 1 + 1 + 3 + 3
        if T.MODE_HAS_ETC1_BIAS[mode]:
            ofs += 5
        if T.MODE_HAS_ALPHA[mode]:
            ofs += 8
        tgt = gi[better]
        for k in range(tgt.shape[0]):
            field = (int(scratch[k, 0]) | (int(scratch[k, 1]) << 64)) \
                & ((1 << nbits_ep) - 1)
            whole = int.from_bytes(bytes(out[tgt[k]]), "little")
            whole &= ~(((1 << nbits_ep) - 1) << ofs)
            whole |= field << ofs
            out[tgt[k]] = np.frombuffer(whole.to_bytes(16, "little"),
                                        np.uint8)

