"""Copy of `basis_universal_tpu/codecs/astc/xuastc_arith_encode.py`.

XUASTC LDR FullArith / HybridArithZstd entropy syntaxes — encode side.

The full-zstd writer (xuastc_encode.py) picks the per-block emission
decisions (RUN / SOLID / config+endpoint REUSE / RAW); this module emits
the SAME decisions through the adaptive binary arithmetic coder instead,
producing syntax 0 (FullArith: one arith stream carries everything) or
syntax 1 (HybridArithZstd: arith stream for structure + Zstd side streams
for DCT/weight payloads). Stream contract mirrored from our oracle-tested
decoder `xuastc_ldr.decode_log_blocks_arith` (reference encoder:
encoder/basisu_astc_ldr_encode.cpp compress_image_arith paths; syntax ids
transcoder/basisu_transcoder_internal.h:2177-2184).
"""

import struct

import numpy as np

from ...entropy import arith
from . import helpers as ah
from . import xuastc_cems as XC
from . import xuastc_dct as XD
from . import xuastc_tables as XT
from .hdr6x6_tables import REUSE_XY_DELTAS
from .xuastc_ldr import _grouped_trial_modes

_CEM_TO_LDRCEM = {0: 0, 4: 1, 6: 2, 8: 3, 9: 4, 10: 5, 12: 6, 13: 7}


class _St:
    __slots__ = ("was_solid", "used_dct", "uses_bc", "reused_cfg",
                 "used_part_hash", "tm_index", "base_cem", "subset",
                 "ccs", "grid_size", "grid_aniso")

    def __init__(self):
        self.was_solid = False
        self.used_dct = False
        self.uses_bc = False
        self.reused_cfg = False
        self.used_part_hash = False
        self.tm_index = 0
        self.base_cem = 0
        self.subset = 0
        self.ccs = 0
        self.grid_size = 0
        self.grid_aniso = 0


def _copy_state(ns, prev, reused):
    ns.was_solid = prev.was_solid
    ns.used_dct = prev.used_dct
    ns.uses_bc = prev.uses_bc
    ns.reused_cfg = reused
    ns.tm_index = prev.tm_index
    ns.base_cem = prev.base_cem
    ns.subset = prev.subset
    ns.ccs = prev.ccs
    ns.grid_size = prev.grid_size
    ns.grid_aniso = prev.grid_aniso
    ns.used_part_hash = prev.used_part_hash


def _copy_cfg_state(ns, prev):
    ns.reused_cfg = True
    ns.tm_index = prev.tm_index
    ns.base_cem = prev.base_cem
    ns.subset = prev.subset
    ns.ccs = prev.ccs
    ns.grid_size = prev.grid_size
    ns.grid_aniso = prev.grid_aniso
    ns.used_part_hash = prev.used_part_hash


def _group_of(tm_index: int, groups) -> tuple:
    for key, modes in groups.items():
        if tm_index in modes:
            return key, modes.index(tm_index)
    raise ValueError(f"trial mode {tm_index} not in grouped table")


class _Bits:
    """LSB-first bit accumulator for the hybrid side streams."""

    def __init__(self):
        self.bits = []

    def put(self, value: int, nbits: int):
        for k in range(nbits):
            self.bits.append((value >> k) & 1)

    def to_bytes(self) -> bytes:
        out = bytearray((len(self.bits) + 7) // 8)
        for i, b in enumerate(self.bits):
            if b:
                out[i >> 3] |= 1 << (i & 7)
        return bytes(out)


def emit_arith(blocks, info, *, bsi: int, width: int, height: int,
               has_alpha: bool, srgb: bool, use_dct: bool, q: float,
               nbx: int, nby: int, hybrid: bool) -> bytes:
    """Emit FullArith (hybrid=False) or HybridArithZstd (hybrid=True)."""
    bw, bh = XT.ASTC_BLOCK_SIZES[bsi]
    trial_modes = XT.encoder_trial_modes(bsi)
    groups = _grouped_trial_modes(bsi)
    group_of = {}
    for key, modes in groups.items():
        for pos, tmi in enumerate(modes):
            group_of[tmi] = (key, pos)

    enc = arith.ArithEncoder()
    enc.put_bits(0x01, 5)                      # ARITH_HEADER_MARKER
    enc.put_bits(bsi, 4)
    enc.put_bits(1 if srgb else 0, 1)
    enc.put_bits(width, 16)
    enc.put_bits(height, 16)
    enc.put_bits(1 if has_alpha else 0, 1)
    enc.put_bits(1 if use_dct else 0, 1)
    if use_dct:
        enc.put_bits(int(round(q * 2.0)), 8)

    # models — construction order and parameters must mirror the decoder
    mode_model = arith.DataModel(6)
    solid_dpcm = [arith.DataModel(256, faster_update=True) for _ in range(4)]
    raw_ep_models = [arith.DataModel(ah.ise_levels(r)) for r in range(4, 21)]
    is_base_ofs_model = arith.BitModel()
    use_dct_models = [arith.BitModel() for _ in range(4)]
    use_dpcm_model = arith.BitModel()
    cem_index_models = [arith.DataModel(14) for _ in range(8)]
    subset_models = [arith.DataModel(3) for _ in range(3)]
    ccs_models = [arith.DataModel(5) for _ in range(5)]
    grid_size_models = [arith.DataModel(2) for _ in range(2)]
    grid_aniso_models = [arith.DataModel(3) for _ in range(3)]
    submode_models = {}
    cfg_reuse_models = [arith.DataModel(4) for _ in range(4)]
    run_ctxs = arith.GammaContexts()
    use_part_hash_models = [arith.BitModel() for _ in range(4)]
    part2_hash_model = arith.DataModel(XT.PART_HASH_SIZE, faster_update=True)
    part3_hash_model = arith.DataModel(XT.PART_HASH_SIZE, faster_update=True)
    if not hybrid:
        dct_run_model = arith.DataModel(65)
        dct_coeff_model = arith.DataModel(255)
        mean_models = [arith.DataModel(XD.DCT_MEAN_LEVELS0),
                       arith.DataModel(XD.DCT_MEAN_LEVELS1)]
        raw_weight_models = [arith.DataModel(ah.ise_levels(r))
                             for r in range(0, 12)]
    else:
        mean0 = _Bits()
        mean1 = _Bits()
        run_bytes = _Bits()
        coeff_bytes = _Bits()
        sign_bits = _Bits()
        w2 = _Bits()
        w3 = _Bits()
        w4 = _Bits()
        w8 = _Bits()

    part2_hash = [-1] * XT.PART_HASH_SIZE
    part3_hash = [-1] * XT.PART_HASH_SIZE
    log_ring = [[None] * nbx for _ in range(8)]
    st_ring = [[None] * nbx for _ in range(2)]

    def _cfg_key(blk):
        return (blk.cems, blk.dual_plane, blk.ccs, blk.num_partitions,
                blk.partition_id, blk.endpoint_ise_range,
                blk.weight_ise_range, blk.grid_width, blk.grid_height)

    def _blk_key(blk):
        if blk.solid_ldr:
            return ("solid", blk.solid_color)
        return (_cfg_key(blk), tuple(blk.endpoints), tuple(blk.weights))

    keys = [_blk_key(b) for b in blocks]

    def emit_weights(blk, dct, tm_index):
        total_planes = 2 if blk.dual_plane else 1
        if dct is not None:
            num_dc_levels = XD.get_num_weight_dc_levels(blk.weight_ise_range)
            for plane in range(total_planes):
                dc_sym, ndc, coeffs = dct[plane]
                assert ndc == num_dc_levels
                if hybrid:
                    if ndc == XD.DCT_MEAN_LEVELS1:
                        mean1.put(dc_sym, 8)
                    else:
                        mean0.put(dc_sym, 4)
                else:
                    enc.encode_sym(dc_sym, mean_models[
                        1 if ndc == XD.DCT_MEAN_LEVELS1 else 0])
                for num_zeros, coeff in coeffs:
                    if coeff is None:          # EOB
                        if hybrid:
                            run_bytes.put(XD.DCT_RUN_LEN_EOB_SYM_INDEX, 8)
                        else:
                            enc.encode_sym(XD.DCT_RUN_LEN_EOB_SYM_INDEX,
                                           dct_run_model)
                    else:
                        if hybrid:
                            run_bytes.put(num_zeros, 8)
                            sign_bits.put(1 if coeff < 0 else 0, 1)
                            coeff_bytes.put(abs(coeff) - 1, 8)
                        else:
                            enc.encode_sym(num_zeros, dct_run_model)
                            enc.put_bit(1 if coeff < 0 else 0)
                            enc.encode_sym(abs(coeff) - 1, dct_coeff_model)
            return
        wtab = XT.weight_tab(blk.weight_ise_range)
        n_levels = int(wtab.ise_to_val.shape[0])
        nw = blk.grid_width * blk.grid_height
        for plane in range(total_planes):
            prev_w = n_levels // 2
            for k in range(nw):
                cur = int(wtab.ise_to_rank[
                    blk.weights[k * total_planes + plane]])
                delta = (cur - prev_w) % n_levels
                prev_w = cur
                if not hybrid:
                    enc.encode_sym(delta,
                                   raw_weight_models[blk.weight_ise_range])
                elif n_levels <= 4:
                    w2.put(delta, 2)
                elif n_levels <= 8:
                    w3.put(delta, 4)
                elif n_levels <= 16:
                    w4.put(delta, 4)
                else:
                    w8.put(delta, 8)

    i = 0
    n_blocks = nbx * nby
    while i < n_blocks:
        bx = i % nbx
        by = i // nbx
        blk = blocks[i]
        left = st_ring[by & 1][bx - 1] if bx else None
        up = st_ring[(by - 1) & 1][bx] if by else None
        diag = st_ring[(by - 1) & 1][bx - 1] if (bx and by) else None
        pred = left if left is not None else up

        prev_blk = (log_ring[by & 7][bx - 1] if bx
                    else (log_ring[(by - 1) & 7][bx] if by else None))

        # RUN (mode 5): gamma-coded, confined to the rest of the row
        if prev_blk is not None and keys[i] == _blk_key(prev_blk):
            run_len = 1
            max_run = nbx - bx
            while (run_len < max_run and i + run_len < n_blocks
                   and keys[i + run_len] == keys[i]):
                run_len += 1
            enc.encode_sym(5, mode_model)
            enc.put_gamma(run_len, run_ctxs)
            prev_st = left if left is not None else up
            for j in range(run_len):
                cx = bx + j
                ns = _St()
                _copy_state(ns, prev_st, reused=True)
                st_ring[by & 1][cx] = ns
                log_ring[by & 7][cx] = prev_blk
                prev_st = ns
            i += run_len
            continue

        ns = _St()
        st_ring[by & 1][bx] = ns

        if blk.solid_ldr:
            enc.encode_sym(0, mode_model)
            prev_c = [0, 0, 0, 0]
            if prev_blk is not None:
                if prev_blk.solid_ldr:
                    prev_c = [v >> 8 for v in prev_blk.solid_color]
                else:
                    pl, ph = XC.decode_endpoints(
                        prev_blk.cems[0], prev_blk.endpoints,
                        prev_blk.endpoint_ise_range)
                    prev_c = [(pl[k] + ph[k] + 1) >> 1 for k in range(4)]
            col = [v >> 8 for v in blk.solid_color]
            for comp in range(4 if has_alpha else 3):
                enc.encode_sym((col[comp] - prev_c[comp]) & 0xFF,
                               solid_dpcm[comp])
            log_ring[by & 7][bx] = blk
            ns.used_dct = bool(use_dct)
            ns.uses_bc = True
            ns.was_solid = True
            ns.tm_index = -1
            ns.base_cem = 8
            ns.used_part_hash = True
            i += 1
            continue

        tm_index, base_ofs, upi, dct = info[i]
        actual_cem = blk.cems[0]
        my_cfg = _cfg_key(blk)
        neigh = ((0, left, log_ring[by & 7][bx - 1] if bx else None),
                 (1, up, log_ring[(by - 1) & 7][bx] if by else None),
                 (2, diag, log_ring[(by - 1) & 7][bx - 1]
                  if (bx and by) else None))
        reuse_idx = -1
        cfg_idx = -1
        cfg_st_pick = None
        for idx, nb_st, nb_blk in neigh:
            if nb_st is None or nb_blk is None or nb_blk.solid_ldr \
                    or nb_st.tm_index != tm_index or nb_st.tm_index < 0:
                continue
            if _cfg_key(nb_blk) != my_cfg:
                continue
            if cfg_idx < 0:
                cfg_idx = idx
                cfg_st_pick = nb_st
            if (reuse_idx < 0
                    and list(nb_blk.endpoints) == list(blk.endpoints)):
                reuse_idx = idx
                cfg_st_pick = nb_st
                break

        if reuse_idx >= 0:
            enc.encode_sym(2 + reuse_idx, mode_model)
            _copy_cfg_state(ns, cfg_st_pick)
            if actual_cem in XT.CEMS_SUPPORT_BC:
                ns.uses_bc = XC.used_blue_contraction(
                    actual_cem, blk.endpoints, blk.endpoint_ise_range)
        else:
            enc.encode_sym(1, mode_model)                 # RAW
            ridx = (1 if left is None else int(left.reused_cfg)) \
                | ((1 if up is None else int(up.reused_cfg)) << 1)
            if cfg_idx >= 0:
                enc.encode_sym(cfg_idx, cfg_reuse_models[ridx])
                _copy_cfg_state(ns, cfg_st_pick)
            else:
                enc.encode_sym(3, cfg_reuse_models[ridx])
                prev_cem, prev_sub, prev_ccs = 8, 0, 0
                prev_gs, prev_ga = 0, 0
                if pred is not None:
                    prev_cem = pred.base_cem
                    prev_sub = pred.subset
                    prev_ccs = pred.ccs
                    prev_gs = pred.grid_size
                    prev_ga = pred.grid_aniso
                key, submode = group_of[tm_index]
                cem_index, subset_index, ccs_index, gs_index, ga_index = key
                enc.encode_sym(cem_index,
                               cem_index_models[_CEM_TO_LDRCEM[prev_cem]])
                enc.encode_sym(subset_index, subset_models[prev_sub])
                enc.encode_sym(ccs_index, ccs_models[prev_ccs])
                enc.encode_sym(gs_index, grid_size_models[prev_gs])
                enc.encode_sym(ga_index, grid_aniso_models[prev_ga])
                modes = groups[key]
                if len(modes) > 1:
                    sm = submode_models.get(key)
                    if sm is None:
                        sm = arith.DataModel(len(modes), faster_update=True)
                        submode_models[key] = sm
                    enc.encode_sym(submode, sm)
                ns.tm_index = tm_index
                ns.base_cem = cem_index
                ns.subset = subset_index
                ns.ccs = ccs_index
                ns.grid_size = gs_index
                ns.grid_aniso = ga_index
                ns.reused_cfg = False

                tm = trial_modes[tm_index]
                if tm.cem in (8, 12):
                    enc.encode_bit(1 if base_ofs else 0, is_base_ofs_model)
                if tm.num_parts > 1:
                    total_unique = XT.get_total_unique_patterns(
                        bsi, tm.num_parts)
                    pidx = (1 if left is None else int(left.used_part_hash)) \
                        | ((1 if up is None else
                            int(up.used_part_hash)) << 1)
                    phash = part2_hash if tm.num_parts == 2 else part3_hash
                    hidx = XT.part_hash_index(upi)
                    if phash[hidx] == upi:
                        enc.encode_bit(1, use_part_hash_models[pidx])
                        enc.encode_sym(hidx,
                                       part2_hash_model if tm.num_parts == 2
                                       else part3_hash_model)
                        ns.used_part_hash = True
                    else:
                        enc.encode_bit(0, use_part_hash_models[pidx])
                        enc.put_truncated_binary(upi, total_unique)
                        phash[hidx] = upi
                        ns.used_part_hash = False
                else:
                    ns.used_part_hash = True

            # endpoints: always the raw path (use_dpcm = 0), mirroring the
            # full-zstd writer which leaves the DPCM side streams empty
            enc.encode_bit(0, use_dpcm_model)
            rm = raw_ep_models[blk.endpoint_ise_range - 4]
            for v in blk.endpoints:
                enc.encode_sym(int(v), rm)
            if actual_cem in XT.CEMS_SUPPORT_BC:
                ns.uses_bc = XC.used_blue_contraction(
                    actual_cem, blk.endpoints, blk.endpoint_ise_range)

        # weights
        didx = 0
        if use_dct:
            didx = (1 if left is None else int(left.used_dct)) \
                | ((1 if up is None else int(up.used_dct)) << 1)
            enc.encode_bit(1 if dct is not None else 0, use_dct_models[didx])
        if dct is not None:
            ns.used_dct = True
        emit_weights(blk, dct, tm_index)
        log_ring[by & 7][bx] = blk
        ns.tm_index = tm_index
        i += 1

    enc.put_bits(0xAF, 8)                      # FINAL_SYNC_MARKER
    arith_bytes = enc.flush()

    if not hybrid:
        return bytes([0]) + arith_bytes        # SYNTAX_FULL_ARITH

    import zstandard

    cctx = zstandard.ZstdCompressor(level=19)

    def z(bits: _Bits, raw=False):
        data = bits.to_bytes()
        if raw or not data:
            return data
        return cctx.compress(data)

    side = [z(mean0), z(mean1), z(run_bytes), z(coeff_bytes),
            z(sign_bits, raw=True), z(w2), z(w3), z(w4), z(w8)]
    lens = [len(arith_bytes)] + [len(s) for s in side] + [0]
    out = bytearray()
    out.append(1)                              # SYNTAX_HYBRID_ARITH_ZSTD
    out += struct.pack("<11I", *lens)
    out += arith_bytes
    for s in side:
        out += s
    return bytes(out)
