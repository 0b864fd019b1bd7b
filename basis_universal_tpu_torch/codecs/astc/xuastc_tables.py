"""Copy of `basis_universal_tpu/codecs/astc/xuastc_tables.py`.

XUASTC LDR shared tables (trial modes, dequant ranks, unique partitions).

Parity sources (cited, format-spec material — bit-exact interop requires
identical tables):
  - s_astc_cfg_table: transcoder/basisu_astc_cfgs.inl (10311 packed u24
    configs, stored here as xuastc_cfgs.npz); unpack loop
    create_encoder_trial_modes_table, transcoder/basisu_transcoder.cpp:27357.
  - dequant rank tables: astc_helpers create_quant_tables
    (basisu_astc_helpers.h:282, :1448 find_nearest) — generated, not copied.
  - unique partition patterns: generated from the canonical ASTC partition
    function exactly as the reference's offline enumeration (validated
    against g_total_unique_patterns, basisu_transcoder.cpp:27500 and the
    g_unique_to_seed_* tables' leading entries).
  - preserve2/preserve3 quantize tables: init_quantize_tables,
    basisu_transcoder.cpp:23013.
  - base+offset nudge tables: compute_base_ofs_requantize_tabs,
    basisu_transcoder.cpp:25344.
"""

import dataclasses
import functools
import pathlib

import numpy as np

from ..uastc.tables import BISE_RANGE_TABLE, astc_select_partition
from . import helpers as ah

# astc_helpers::g_astc_block_sizes (basisu_astc_helpers.h:633)
ASTC_BLOCK_SIZES = [(4, 4), (5, 4), (5, 5), (6, 5), (6, 6), (8, 5), (8, 6),
                    (10, 5), (10, 6), (8, 8), (10, 8), (10, 10), (12, 10),
                    (12, 12)]

FIRST_VALID_ENDPOINT_ISE_RANGE = 4    # BISE_6_LEVELS
LAST_VALID_ENDPOINT_ISE_RANGE = 20    # BISE_256_LEVELS
FIRST_VALID_WEIGHT_ISE_RANGE = 0      # BISE_2_LEVELS
LAST_VALID_WEIGHT_ISE_RANGE = 11      # BISE_32_LEVELS

# CEM ids (astc_helpers.h enum cems)
CEM_LDR_LUM_DIRECT = 0
CEM_LDR_LUM_BASE_PLUS_OFS = 1
CEM_LDR_LUM_ALPHA_DIRECT = 4
CEM_LDR_LUM_ALPHA_BASE_PLUS_OFS = 5
CEM_LDR_RGB_BASE_SCALE = 6
CEM_LDR_RGB_DIRECT = 8
CEM_LDR_RGB_BASE_PLUS_OFFSET = 9
CEM_LDR_RGB_BASE_SCALE_PLUS_TWO_A = 10
CEM_LDR_RGBA_DIRECT = 12
CEM_LDR_RGBA_BASE_PLUS_OFFSET = 13

# basisu_transcoder.cpp:25333
UNIQUE_LDR_INDEX_TO_ASTC_CEM = [0, 4, 6, 8, 10, 12]

LDR_CEMS = {0, 1, 4, 5, 6, 8, 9, 10, 12, 13}
CEMS_WITH_ALPHA = {4, 5, 10, 12, 13}
CEMS_SUPPORT_BC = {8, 9, 12, 13}


def cem_num_values(cem: int) -> int:
    return 2 + 2 * (cem >> 2)


def get_base_cem_without_alpha(cem: int) -> int:
    return {4: 0, 12: 8, 10: 6, 13: 9}.get(cem, cem)


@dataclasses.dataclass(frozen=True)
class TrialMode:
    grid_width: int
    grid_height: int
    cem: int
    ccs_index: int            # -1 = single plane
    endpoint_ise_range: int
    weight_ise_range: int
    num_parts: int


@functools.lru_cache(maxsize=None)
def _cfg_table() -> np.ndarray:
    p = pathlib.Path(__file__).with_name("xuastc_cfgs.npz")
    return np.load(p)["cfgs"]


@functools.lru_cache(maxsize=None)
def encoder_trial_modes(block_size_index: int):
    """Per-block-size trial mode list (g_encoder_trial_modes analog)."""
    bw, bh = ASTC_BLOCK_SIZES[block_size_index]
    out = []
    for packed in _cfg_table():
        v = int(packed)
        e_ise = v & 31; v >>= 5            # CFG_PACK_EISE_BITS
        w_ise = v & 15; v >>= 4            # CFG_PACK_WISE_BITS
        ccs = v & 7; v >>= 3               # CFG_PACK_CCS_BITS
        subsets = v & 3; v >>= 2           # CFG_PACK_SUBSETS_BITS
        ucem = v & 7; v >>= 3              # CFG_PACK_CEM_BITS
        grid_wh = v & 127                  # CFG_PACK_GRID_BITS
        gw = grid_wh // 11 + 2
        if gw > bw:
            break                           # table sorted by grid width
        gh = grid_wh % 11 + 2
        if gh > bh:
            continue
        out.append(TrialMode(
            grid_width=gw, grid_height=gh,
            cem=UNIQUE_LDR_INDEX_TO_ASTC_CEM[ucem],
            ccs_index=ccs - 1,
            endpoint_ise_range=e_ise + FIRST_VALID_ENDPOINT_ISE_RANGE,
            weight_ise_range=w_ise,
            num_parts=subsets + 1))
    return out


# --- dequant tables ----------------------------------------------------------

@dataclasses.dataclass
class DequantTable:
    ise_to_val: np.ndarray     # [levels]
    val_to_ise: np.ndarray     # [256] or [65]
    ise_to_rank: np.ndarray    # [levels]
    rank_to_ise: np.ndarray    # [levels]


@functools.lru_cache(maxsize=None)
def endpoint_tab(ise_range: int) -> DequantTable:
    assert FIRST_VALID_ENDPOINT_ISE_RANGE <= ise_range <= LAST_VALID_ENDPOINT_ISE_RANGE
    n = ah.ise_levels(ise_range)
    ise_to_val = np.array([ah.dequant_endpoint(i, ise_range)
                           for i in range(n)], dtype=np.int64)
    return _mk_tab(ise_to_val, 256, ise_range)


@functools.lru_cache(maxsize=None)
def weight_tab(ise_range: int) -> DequantTable:
    assert FIRST_VALID_WEIGHT_ISE_RANGE <= ise_range <= LAST_VALID_WEIGHT_ISE_RANGE
    n = ah.ise_levels(ise_range)
    ise_to_val = np.array([ah.dequant_weight(i, ise_range)
                           for i in range(n)], dtype=np.int64)
    return _mk_tab(ise_to_val, 65, ise_range)


def _mk_tab(ise_to_val: np.ndarray, n_vals: int, ise_range: int) -> DequantTable:
    n = ise_to_val.shape[0]
    # val_to_ise: nearest level, first-wins tie-break (find_nearest_bise_*)
    val_to_ise = np.zeros(n_vals, dtype=np.int64)
    for v in range(n_vals):
        errs = np.abs(v - ise_to_val)
        val_to_ise[v] = int(np.argmin(errs))   # argmin = first index on ties
    b, t, q = BISE_RANGE_TABLE[ise_range]
    if not t and not q:
        rank_to_ise = np.arange(n, dtype=np.int64)
        ise_to_rank = np.arange(n, dtype=np.int64)
    else:
        # sort by (dequant value, ise symbol) — the reference packs
        # (val<<16)|ise and sorts the u32 keys
        order = np.lexsort((np.arange(n), ise_to_val))
        rank_to_ise = order.astype(np.int64)
        ise_to_rank = np.zeros(n, dtype=np.int64)
        ise_to_rank[order] = np.arange(n)
    return DequantTable(ise_to_val=ise_to_val, val_to_ise=val_to_ise,
                        ise_to_rank=ise_to_rank, rank_to_ise=rank_to_ise)


@functools.lru_cache(maxsize=None)
def quantize_preserve2(ise_range: int) -> np.ndarray:
    """Nearest endpoint level preserving the value's top-2 bits
    (g_quantize_tables_preserve2; valid for >= BISE_6_LEVELS)."""
    tab = endpoint_tab(ise_range)
    out = np.zeros(256, dtype=np.int64)
    for v in range(256):
        mask = (tab.ise_to_val & 0xC0) == (v & 0xC0)
        errs = np.where(mask, (tab.ise_to_val - v) ** 2, 1 << 30)
        out[v] = int(np.argmin(errs))
    return out


@functools.lru_cache(maxsize=None)
def base_ofs_nudges(ise_range: int):
    """(pos_nudge[levels], neg_nudge[levels]) per
    compute_base_ofs_requantize_tabs (basisu_transcoder.cpp:25344)."""
    tab = endpoint_tab(ise_range)
    n = tab.ise_to_val.shape[0]

    def decoded(v):
        a, b = int(v), 0
        b = (b >> 1) | (a & 0x80)
        a = (a >> 1) & 0x3F
        if a & 0x20:
            a -= 0x40
        return a, b

    out = []
    for delta in (1, -1):
        res = np.arange(n, dtype=np.int64)
        for cur in range(n):
            cur_a, cur_b = decoded(tab.ise_to_val[cur])
            best_err, best = None, cur
            for trial in range(n):
                t_a, t_b = decoded(tab.ise_to_val[trial])
                if t_b != cur_b or t_a == cur_a:
                    continue
                if delta < 0 and t_a > cur_a:
                    continue
                if delta > 0 and t_a < cur_a:
                    continue
                err = abs(t_a - cur_a)
                if best_err is None or err < best_err:
                    best_err, best = err, trial
            res[cur] = best
        out.append(res)
    return tuple(out)   # (pos, neg)


# --- unique partition patterns ----------------------------------------------

@functools.lru_cache(maxsize=None)
def unique_partitions(block_size_index: int, num_parts: int):
    """(seed_list, pattern-lookup) — seeds of canonical unique patterns in
    ascending seed order (matches the reference's baked
    g_unique_to_seed_<size>_p<n> tables; validated against
    g_total_unique_patterns counts)."""
    bw, bh = ASTC_BLOCK_SIZES[block_size_index]
    small = bw * bh < 31
    seen = set()
    seeds = []
    for seed in range(1024):
        pat = tuple(astc_select_partition(seed, x, y, 0, num_parts, small)
                    for y in range(bh) for x in range(bw))
        if len(set(pat)) != num_parts:
            continue
        m = {}
        canon = []
        for v in pat:
            if v not in m:
                m[v] = len(m)
            canon.append(m[v])
        canon = tuple(canon)
        if canon in seen:
            continue
        seen.add(canon)
        seeds.append(seed)
    return seeds


# validated totals (basisu_transcoder.cpp g_total_unique_patterns)
TOTAL_UNIQUE_PATTERNS = [
    (437, 329), (559, 405), (659, 486), (720, 534),
    (521, 333), (584, 377), (640, 410), (672, 436),
    (710, 468), (701, 476), (759, 528), (799, 568),
    (818, 597), (838, 626),
]


def get_total_unique_patterns(block_size_index: int, num_parts: int) -> int:
    return TOTAL_UNIQUE_PATTERNS[block_size_index][num_parts - 2]


def unique_pat_index_to_part_seed(block_size_index: int, num_parts: int,
                                  unique_pat_index: int) -> int:
    return unique_partitions(block_size_index, num_parts)[unique_pat_index]


# hash helpers (basisu_transcoder_internal.h:1540,:2192)
PART_HASH_BITS = 6
PART_HASH_SIZE = 1 << PART_HASH_BITS
TM_HASH_BITS = 7
TM_HASH_SIZE = 1 << TM_HASH_BITS


def part_hash_index(x: int) -> int:
    return (x * 2654435769) & (PART_HASH_SIZE - 1)


def tm_hash_index(x: int) -> int:
    return (x * 2654435769) & (TM_HASH_SIZE - 1)
