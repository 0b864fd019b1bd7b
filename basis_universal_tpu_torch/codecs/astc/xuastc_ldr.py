"""Copy of `basis_universal_tpu/codecs/astc/xuastc_ldr.py`.

XUASTC LDR (supercompressed ASTC LDR 4x4-12x12) — complete decoder.

All three entropy syntaxes decode to logical ASTC blocks, pixel-exact vs
the reference transcoder (tests/test_xuastc.py oracle conformance):

- full-zstd container parsing (parity: transcoder/
  basisu_transcoder_internal.h xuastc_ldr_full_zstd_header:1500,
  basisu_transcoder.cpp xuastc_ldr_decompress_image_full_zstd:27633) —
  syntax marker, 21-length header, raw-bits metadata stream, 20 Zstd side
  streams — then per-block decode in `decode_log_blocks` (run/solid/raw
  commands, config-reuse + trial-mode hash, endpoint DPCM with BC-interop,
  weight-grid DCT dequant + IDCT; basisu_transcoder.cpp:27800-28560).
- full-arith and hybrid-arith-zstd syntaxes in `decode_log_blocks_arith`
  (adaptive binary models per stream; basisu_transcoder_internal.h
  arith_dec:2976, syntax ids :2177-2184).

`decode_any` probes the syntax byte and dispatches; `decode_rgba` /
`decode_astc_physical` are the image-level entry points used by
transcoder.py.
"""

import dataclasses
import struct
from typing import Dict

SYNTAX_FULL_ARITH = 0
SYNTAX_HYBRID_ARITH_ZSTD = 1
SYNTAX_FULL_ZSTD = 2

_STREAM_NAMES = [
    "mode_bytes", "solid_dpcm_bytes", "endpoint_dpcm_reuse_indices",
    "use_bc_bits", "endpoint_dpcm_3bit", "endpoint_dpcm_4bit",
    "endpoint_dpcm_5bit", "endpoint_dpcm_6bit", "endpoint_dpcm_7bit",
    "endpoint_dpcm_8bit", "mean0_bits", "mean1_bytes", "run_bytes",
    "coeff_bytes", "sign_bits", "weight2_bits", "weight3_bits",
    "weight4_bits", "weight8_bytes",
]

# g_astc_block_sizes order (basisu_astc_helpers.h:633)
ASTC_BLOCK_SIZES = [(4, 4), (5, 4), (5, 5), (6, 5), (6, 6), (8, 5), (8, 6),
                    (10, 5), (10, 6), (8, 8), (10, 8), (10, 10), (12, 10),
                    (12, 12)]


@dataclasses.dataclass
class XuastcContainer:
    syntax: int
    block_w: int
    block_h: int
    width: int
    height: int
    has_alpha: bool
    srgb_decode: bool
    use_dct: bool
    dct_q: float
    raw_bits: bytes                 # remaining metadata/bit stream
    raw_bits_start_bit: int         # bit offset where block data resumes
    streams: Dict[str, bytes]       # decompressed side streams


class _LsbReader:
    def __init__(self, data: bytes):
        self.data = data
        self.pos = 0
        self.buf = 0
        self.nbits = 0

    def get(self, n: int) -> int:
        while self.nbits < n:
            c = self.data[self.pos] if self.pos < len(self.data) else 0
            self.pos += 1
            self.buf |= c << self.nbits
            self.nbits += 8
        v = self.buf & ((1 << n) - 1)
        self.buf >>= n
        self.nbits -= n
        return v

    def bit_position(self) -> int:
        return self.pos * 8 - self.nbits


def parse_container(data: bytes) -> XuastcContainer:
    """Validate + split a full-zstd XUASTC LDR slice into its streams."""
    import zstandard

    if len(data) < 1 + 21 * 4:
        raise ValueError("XUASTC stream too small")
    syntax = data[0] & 3
    if syntax != SYNTAX_FULL_ZSTD:
        raise NotImplementedError(
            f"XUASTC syntax {syntax} (arith/hybrid) not supported yet")
    lens = struct.unpack_from("<21I", data, 1)
    raw_bits_len = lens[0]
    stream_lens = lens[1:20]        # 19 side streams + unused tail
    if not raw_bits_len or not stream_lens[0]:
        # reference rejects empty raw_bits/mode_bytes (transcoder.cpp:27649)
        raise ValueError("XUASTC stream has empty raw_bits or mode_bytes")
    pos = 1 + 21 * 4
    raw_bits = data[pos:pos + raw_bits_len]
    pos += raw_bits_len

    dctx = zstandard.ZstdDecompressor()
    streams = {}
    for name, ln in zip(_STREAM_NAMES, stream_lens):
        if not ln:
            streams[name] = b""
        elif name == "sign_bits":
            # sign_bits is stored RAW, not Zstd (transcoder.cpp:27716-27721)
            streams[name] = data[pos:pos + ln]
            pos += ln
        else:
            streams[name] = dctx.decompress(
                data[pos:pos + ln], max_output_size=1 << 28)
            pos += ln
    if pos > len(data):
        raise ValueError("XUASTC stream truncated")

    br = _LsbReader(raw_bits)
    if br.get(5) != 0x01:  # FULL_ZSTD_HEADER_MARKER
        raise ValueError("bad XUASTC raw-bits marker")
    bsi = br.get(4)
    if bsi >= len(ASTC_BLOCK_SIZES):
        raise ValueError("bad ASTC block size index")
    bw, bh = ASTC_BLOCK_SIZES[bsi]
    srgb = bool(br.get(1))
    width = br.get(16)
    height = br.get(16)
    has_alpha = bool(br.get(1))
    use_dct = bool(br.get(1))
    int_q = br.get(8) if use_dct else 0
    dct_q = int_q / 2.0
    if use_dct and not (0.0 < dct_q <= 100.0):
        raise ValueError("invalid XUASTC DCT global quality factor")
    return XuastcContainer(
        syntax=syntax, block_w=bw, block_h=bh, width=width, height=height,
        has_alpha=has_alpha, srgb_decode=srgb, use_dct=use_dct, dct_q=dct_q,
        raw_bits=raw_bits, raw_bits_start_bit=br.bit_position(),
        streams=streams)


class _SimpleBits:
    """simplified_bitwise_decoder analog: LSB-first within each byte, codes
    never cross byte boundaries (basisu_transcoder_internal.h:753)."""

    def __init__(self, data: bytes):
        self.data = data
        self.pos = 0
        self.buf = 1

    def get(self, n: int) -> int:
        if self.buf <= 1:
            b = self.data[self.pos] if self.pos < len(self.data) else 0
            self.pos += 1
            self.buf = 256 | b
        res = self.buf & ((1 << n) - 1)
        self.buf >>= n
        return res


class _RawBits(_LsbReader):
    """bitwise_decoder analog with truncated-binary decode."""

    def decode_truncated_binary(self, n: int) -> int:
        k = n.bit_length() - 1
        u = (1 << (k + 1)) - n
        result = self.get(k)
        if result >= u:
            result = ((result << 1) | self.get(1)) - u
        return result


# xuastc_zstd_mode (basisu_transcoder_internal.h:2166)
_MODE_BYTE_IS_BASE_OFS = 1 << 3
_MODE_BYTE_PART_HASH_HIT = 1 << 4
_MODE_BYTE_DPCM_ENDPOINTS = 1 << 5
_MODE_BYTE_TM_HASH_HIT = 1 << 6
_MODE_BYTE_USE_DCT = 1 << 7


def decode_log_blocks(data: bytes):
    """Full-zstd XUASTC LDR decode → (container, list-of-LogBlock in raster
    order). Parity: xuastc_ldr_decompress_image_full_zstd
    (transcoder/basisu_transcoder.cpp:27633-28530).

    The command-stream decode is inherently serial (left/up/diag block
    dependencies) and runs on the host; the downstream block->pixel stage
    (helpers.decode_blocks_rgba8) is batched.
    """
    import dataclasses as _dc

    from . import helpers as ah
    from . import xuastc_cems as XC
    from . import xuastc_dct as XD
    from . import xuastc_tables as XT
    from .hdr6x6_tables import REUSE_XY_DELTAS

    c = parse_container(data)
    bsi = XT.ASTC_BLOCK_SIZES.index((c.block_w, c.block_h))
    trial_modes = XT.encoder_trial_modes(bsi)
    nbx = (c.width + c.block_w - 1) // c.block_w
    nby = (c.height + c.block_h - 1) // c.block_h

    raw = _RawBits(c.raw_bits)
    if raw.get(5) != 0x01:
        raise ValueError("bad XUASTC marker")
    # bsi(4) + srgb(1) + w(16) + h(16) + alpha(1) + use_dct(1): already
    # parsed by parse_container
    raw.get(4 + 1 + 16 + 16 + 1 + 1)
    if c.use_dct:
        raw.get(8)

    s = c.streams
    mode_dec = _SimpleBits(s["mode_bytes"])
    solid_dec = _SimpleBits(s["solid_dpcm_bytes"])
    reuse_dec = _SimpleBits(s["endpoint_dpcm_reuse_indices"])
    use_bc_dec = _SimpleBits(s["use_bc_bits"])
    dpcm_decs = {3: _SimpleBits(s["endpoint_dpcm_3bit"]),
                 4: _SimpleBits(s["endpoint_dpcm_4bit"]),
                 5: _SimpleBits(s["endpoint_dpcm_5bit"]),
                 6: _SimpleBits(s["endpoint_dpcm_6bit"]),
                 7: _SimpleBits(s["endpoint_dpcm_7bit"]),
                 8: _SimpleBits(s["endpoint_dpcm_8bit"])}
    mean0 = _SimpleBits(s["mean0_bits"])
    mean1 = _SimpleBits(s["mean1_bytes"])
    run_bytes = _SimpleBits(s["run_bytes"])
    coeff_bytes = _SimpleBits(s["coeff_bytes"])
    sign_bits = _SimpleBits(s["sign_bits"])
    w2 = _SimpleBits(s["weight2_bits"])
    w3 = _SimpleBits(s["weight3_bits"])
    w4 = _SimpleBits(s["weight4_bits"])
    w8 = _SimpleBits(s["weight8_bytes"])

    # ring state: log blocks for the last 8 rows, tm_index for last 2 rows
    log_ring = [[None] * nbx for _ in range(8)]
    tm_ring = [[-1] * nbx for _ in range(2)]
    part2_hash = [-1] * XT.PART_HASH_SIZE
    part3_hash = [-1] * XT.PART_HASH_SIZE
    tm_hash = [-1] * XT.TM_HASH_SIZE

    out = []
    cur_run_len = 0

    def emit(bx, by, blk):
        out.append(blk)
        log_ring[by & 7][bx] = blk

    for by in range(nby):
        for bx in range(nbx):
            left_tm = tm_ring[by & 1][bx - 1] if bx else None
            up_tm = tm_ring[(by - 1) & 1][bx] if by else None
            diag_tm = tm_ring[(by - 1) & 1][bx - 1] if (bx and by) else None

            if cur_run_len:
                prev_blk = log_ring[by & 7][bx - 1] if bx \
                    else log_ring[(by - 1) & 7][bx]
                emit(bx, by, prev_blk)
                tm_ring[by & 1][bx] = left_tm if bx else up_tm
                cur_run_len -= 1
                continue

            mode_byte = mode_dec.get(8)

            if (mode_byte & 3) == 0b01:                     # RUN
                cur_run_len = 1 + (mode_byte >> 2)
                if not bx and not by:
                    raise ValueError("XUASTC run at origin")
                if cur_run_len > nbx - bx:
                    raise ValueError("XUASTC run too long")
                prev_blk = log_ring[by & 7][bx - 1] if bx \
                    else log_ring[(by - 1) & 7][bx]
                emit(bx, by, prev_blk)
                tm_ring[by & 1][bx] = left_tm if bx else up_tm
                cur_run_len -= 1
                continue

            if (mode_byte & 15) == 0b0011:                  # SOLID
                prev_blk = (log_ring[by & 7][bx - 1] if bx else
                            (log_ring[(by - 1) & 7][bx] if by else None))
                prev_c = [0, 0, 0, 0]
                if prev_blk is not None:
                    if prev_blk.solid_ldr:
                        prev_c = [v >> 8 for v in prev_blk.solid_color]
                    else:
                        pl, ph = XC.decode_endpoints(
                            prev_blk.cems[0], prev_blk.endpoints,
                            prev_blk.endpoint_ise_range)
                        prev_c = [(pl[i] + ph[i] + 1) >> 1 for i in range(4)]
                dr = solid_dec.get(8)
                dg = solid_dec.get(8)
                db = solid_dec.get(8)
                da = solid_dec.get(8) if c.has_alpha else 0
                r = (prev_c[0] + dr) & 0xFF
                g = (prev_c[1] + dg) & 0xFF
                b = (prev_c[2] + db) & 0xFF
                a = (prev_c[3] + da) & 0xFF if c.has_alpha else 255
                blk = ah.LogBlock(
                    solid_ldr=True,
                    solid_color=(r | (r << 8), g | (g << 8),
                                 b | (b << 8), a | (a << 8)))
                emit(bx, by, blk)
                tm_ring[by & 1][bx] = -1
                continue

            blk = ah.LogBlock()
            tm_index = 0
            actual_cem = 0

            if (mode_byte & 1) == 0:                        # RAW
                cfg_reuse = (mode_byte >> 1) & 3
                if cfg_reuse < 3:
                    if cfg_reuse == 0:
                        cfg_blk = log_ring[by & 7][bx - 1] if bx else None
                        tm_index = left_tm if left_tm is not None else -1
                    elif cfg_reuse == 1:
                        cfg_blk = log_ring[(by - 1) & 7][bx] if by else None
                        tm_index = up_tm if up_tm is not None else -1
                    else:
                        cfg_blk = (log_ring[(by - 1) & 7][bx - 1]
                                   if (bx and by) else None)
                        tm_index = diag_tm if diag_tm is not None else -1
                    if cfg_blk is None or tm_index is None or tm_index < 0:
                        raise ValueError("XUASTC invalid config reuse")
                    blk.partition_id = cfg_blk.partition_id
                    actual_cem = cfg_blk.cems[0]
                else:
                    if mode_byte & _MODE_BYTE_TM_HASH_HIT:
                        tm_index = tm_hash[raw.get(XT.TM_HASH_BITS)]
                    else:
                        tm_index = raw.decode_truncated_binary(
                            len(trial_modes))
                        tm_hash[XT.tm_hash_index(tm_index)] = tm_index
                    if not (0 <= tm_index < len(trial_modes)):
                        raise ValueError("XUASTC invalid tm_index")
                    tm = trial_modes[tm_index]
                    actual_cem = tm.cem
                    if tm.cem in (XT.CEM_LDR_RGB_DIRECT,
                                  XT.CEM_LDR_RGBA_DIRECT):
                        if mode_byte & _MODE_BYTE_IS_BASE_OFS:
                            actual_cem = tm.cem + 1
                    if tm.num_parts > 1:
                        total_unique = XT.get_total_unique_patterns(
                            bsi, tm.num_parts)
                        phash = part2_hash if tm.num_parts == 2 else part3_hash
                        if mode_byte & _MODE_BYTE_PART_HASH_HIT:
                            upi = phash[raw.get(XT.PART_HASH_BITS)]
                        else:
                            upi = raw.decode_truncated_binary(total_unique)
                            phash[XT.part_hash_index(upi)] = upi
                        if not (0 <= upi < total_unique):
                            raise ValueError("XUASTC invalid pattern index")
                        blk.partition_id = XT.unique_pat_index_to_part_seed(
                            bsi, tm.num_parts, upi)

                tm = trial_modes[tm_index]
                total_vals = XT.cem_num_values(actual_cem)
                blk.cems = (actual_cem,) * tm.num_parts
                blk.num_partitions = tm.num_parts
                blk.dual_plane = tm.ccs_index >= 0
                blk.ccs = tm.ccs_index if blk.dual_plane else 0
                blk.weight_ise_range = tm.weight_ise_range
                blk.endpoint_ise_range = tm.endpoint_ise_range
                blk.grid_width = tm.grid_width
                blk.grid_height = tm.grid_height

                if mode_byte & _MODE_BYTE_DPCM_ENDPOINTS:
                    etab = XT.endpoint_tab(blk.endpoint_ise_range)
                    n_levels = etab.ise_to_val.shape[0]
                    ridx = reuse_dec.get(8)
                    if ridx >= len(REUSE_XY_DELTAS):
                        raise ValueError("XUASTC invalid reuse delta")
                    dx, dy = REUSE_XY_DELTAS[ridx]
                    rbx, rby = bx + dx, by + dy
                    if not (0 <= rbx < nbx and 0 <= rby < nby):
                        raise ValueError("XUASTC reuse delta out of range")
                    pred_blk = log_ring[rby & 7][rbx]
                    if pred_blk is None or pred_blk.solid_ldr:
                        raise ValueError("XUASTC reuse of solid block")
                    use_bc = [False] * blk.num_partitions
                    if actual_cem in XT.CEMS_SUPPORT_BC:
                        for p in range(blk.num_partitions):
                            use_bc[p] = use_bc_dec.get(1) != 0
                    # bits per DPCM delta by level count
                    if n_levels <= 8:
                        dec, nb = dpcm_decs[3], 4
                    elif n_levels <= 16:
                        dec, nb = dpcm_decs[4], 4
                    elif n_levels <= 32:
                        dec, nb = dpcm_decs[5], 8
                    elif n_levels <= 64:
                        dec, nb = dpcm_decs[6], 8
                    elif n_levels <= 128:
                        dec, nb = dpcm_decs[7], 8
                    else:
                        dec, nb = dpcm_decs[8], 8
                    blk.endpoints = [0] * (blk.num_partitions * total_vals)
                    for p in range(blk.num_partitions):
                        pred, _bc, _bo = XC.convert_endpoints_across_cems(
                            pred_blk.cems[0], pred_blk.endpoint_ise_range,
                            pred_blk.endpoints,
                            actual_cem, blk.endpoint_ise_range,
                            False, use_bc[p], False)
                        for v in range(total_vals):
                            delta = dec.get(nb)
                            e_val = (delta + int(etab.ise_to_rank[pred[v]])) \
                                % n_levels
                            blk.endpoints[p * total_vals + v] = int(
                                etab.rank_to_ise[e_val])
                else:
                    blk.endpoints = _decode_values(
                        raw, tm.num_parts * total_vals,
                        blk.endpoint_ise_range)
            elif (mode_byte & 15) >= 0b0111:                # REUSE CFG+EP
                reuse_index = ((mode_byte >> 2) & 3) - 1
                if reuse_index == 0:
                    cfg_blk = log_ring[by & 7][bx - 1] if bx else None
                    tm_index = left_tm if left_tm is not None else -1
                elif reuse_index == 1:
                    cfg_blk = log_ring[(by - 1) & 7][bx] if by else None
                    tm_index = up_tm if up_tm is not None else -1
                else:
                    cfg_blk = (log_ring[(by - 1) & 7][bx - 1]
                               if (bx and by) else None)
                    tm_index = diag_tm if diag_tm is not None else -1
                if cfg_blk is None or tm_index is None or tm_index < 0:
                    raise ValueError("XUASTC invalid cfg+endpoint reuse")
                actual_cem = cfg_blk.cems[0]
                blk.cems = (actual_cem,) * cfg_blk.num_partitions
                blk.dual_plane = cfg_blk.dual_plane
                blk.ccs = cfg_blk.ccs
                blk.num_partitions = cfg_blk.num_partitions
                blk.partition_id = cfg_blk.partition_id
                blk.endpoint_ise_range = cfg_blk.endpoint_ise_range
                blk.weight_ise_range = cfg_blk.weight_ise_range
                blk.grid_width = cfg_blk.grid_width
                blk.grid_height = cfg_blk.grid_height
                total_vals = XT.cem_num_values(actual_cem)
                blk.endpoints = list(
                    cfg_blk.endpoints[:total_vals * blk.num_partitions])
            else:
                raise ValueError("XUASTC invalid mode byte")

            # --- weights
            tm = trial_modes[tm_index]
            total_planes = 2 if tm.ccs_index >= 0 else 1
            total_weights = tm.grid_width * tm.grid_height
            blk.weights = [0] * (total_weights * total_planes)

            block_used_dct = bool(c.use_dct
                                  and (mode_byte & _MODE_BYTE_USE_DCT))
            if block_used_dct:
                num_dc_levels = XD.get_num_weight_dc_levels(
                    blk.weight_ise_range)
                spans = XD.get_max_span_len(blk, XC)
                for plane in range(total_planes):
                    if num_dc_levels == XD.DCT_MEAN_LEVELS1:
                        dc_sym = mean1.get(8)
                    else:
                        dc_sym = mean0.get(4)
                    coeffs = []
                    cur_zig = 1
                    while cur_zig < total_weights:
                        run_len = run_bytes.get(8)
                        if run_len == XD.DCT_RUN_LEN_EOB_SYM_INDEX:
                            break
                        cur_zig += run_len
                        if cur_zig >= total_weights:
                            raise ValueError("XUASTC DCT decode error")
                        sign = sign_bits.get(1)
                        coeff = coeff_bytes.get(8) + 1
                        if sign:
                            coeff = -coeff
                        coeffs.append((run_len, coeff))
                        cur_zig += 1
                    XD.decode_block_weights_from_syms(
                        c.dct_q, plane, blk, c.block_w, c.block_h,
                        dc_sym, coeffs, spans[plane])
            else:
                wtab = XT.weight_tab(blk.weight_ise_range)
                n_levels = int(wtab.ise_to_val.shape[0])
                for plane in range(total_planes):
                    prev_w = n_levels // 2
                    if n_levels < 4:
                        rd, nb, mask = w2, 2, None
                    elif n_levels == 4:
                        rd, nb, mask = w2, 2, 3
                    elif n_levels < 8:
                        rd, nb, mask = w3, 4, None
                    elif n_levels == 8:
                        rd, nb, mask = w3, 4, 7
                    elif n_levels < 16:
                        rd, nb, mask = w4, 4, None
                    elif n_levels == 16:
                        rd, nb, mask = w4, 4, 15
                    else:
                        rd, nb, mask = w8, 8, None
                    for wi in range(total_weights):
                        r = rd.get(nb)
                        if mask is None:
                            w = (prev_w + r) % n_levels
                        else:
                            w = (prev_w + r) & mask
                        prev_w = w
                        blk.weights[plane + wi * total_planes] = int(
                            wtab.rank_to_ise[w])

            emit(bx, by, blk)
            tm_ring[by & 1][bx] = tm_index

    if raw.get(8) != 0xAF:          # FINAL_SYNC_MARKER
        raise ValueError("XUASTC final sync check failed")
    return c, out


def _decode_values(raw, total_values: int, ise_range: int):
    """BISE value decode from the raw-bits stream (decode_values,
    transcoder/basisu_transcoder.cpp:23287)."""
    from ..uastc.tables import BISE_RANGE_TABLE

    bits, trits, quints = BISE_RANGE_TABLE[ise_range]
    total_tqs = 0
    bundle = mul = 0
    if trits:
        total_tqs = (total_values + 4) // 5
        bundle, mul = 5, 3
    elif quints:
        total_tqs = (total_values + 2) // 3
        bundle, mul = 3, 5
    tq = []
    for i in range(total_tqs):
        nb = 8 if trits else 7
        if i == total_tqs - 1:
            rem = total_values - (total_tqs - 1) * bundle
            if trits:
                nb = {1: 2, 2: 4, 3: 5, 4: 7}.get(rem, nb)
            else:
                nb = {1: 3, 2: 5}.get(rem, nb)
        tq.append(raw.get(nb))
    out = []
    accum = 0
    accum_rem = 0
    next_tq = 0
    for _ in range(total_values):
        value = raw.get(bits)
        if total_tqs:
            if not accum_rem:
                accum = tq[next_tq]
                next_tq += 1
                accum_rem = bundle
            value |= (accum % mul) << bits
            accum //= mul
            accum_rem -= 1
        out.append(value)
    return out


def decode_log_blocks_arith(data: bytes):
    """FullArith / HybridArithZstd XUASTC LDR decode → (container-like,
    LogBlock list). Parity: xuastc_ldr_decompress_image
    (transcoder/basisu_transcoder.cpp:28536-29750): adaptive
    bit/data-model coding of modes, configs (grouped trial-mode buckets),
    endpoints and (FullArith) weights."""
    import struct

    from ...entropy import arith
    from . import helpers as ah
    from . import xuastc_cems as XC
    from . import xuastc_dct as XD
    from . import xuastc_tables as XT
    from .hdr6x6_tables import REUSE_XY_DELTAS

    syntax = data[0] & 3
    fast = syntax == SYNTAX_HYBRID_ARITH_ZSTD
    if fast:
        import zstandard    # a FullArith stream needs none

        lens = struct.unpack_from("<11I", data, 1)
        pos = 1 + 11 * 4
        arith_bytes = data[pos:pos + lens[0]]
        pos += lens[0]
        dctx = zstandard.ZstdDecompressor()
        side = []
        for i, ln in enumerate(lens[1:10]):
            raw_stream = data[pos:pos + ln]
            pos += ln
            if i == 4:                          # sign_bits stored raw
                side.append(raw_stream)
            else:
                side.append(dctx.decompress(raw_stream,
                                            max_output_size=1 << 28)
                            if ln else b"")
        (mean0_b, mean1_b, run_b, coeff_b, sign_b,
         w2_b, w3_b, w4_b, w8_b) = side
        mean0 = _SimpleBits(mean0_b)
        mean1 = _SimpleBits(mean1_b)
        run_bytes = _SimpleBits(run_b)
        coeff_bytes = _SimpleBits(coeff_b)
        sign_bits = _SimpleBits(sign_b)
        w2 = _SimpleBits(w2_b)
        w3 = _SimpleBits(w3_b)
        w4 = _SimpleBits(w4_b)
        w8 = _SimpleBits(w8_b)
    else:
        arith_bytes = data[1:]

    dec = arith.ArithDecoder(arith_bytes)
    if dec.get_bits(5) != 0x01:                 # ARITH_HEADER_MARKER
        raise ValueError("bad XUASTC arith marker")
    bsi = dec.get_bits(4)
    bw, bh = XT.ASTC_BLOCK_SIZES[bsi]
    srgb = bool(dec.get_bit())
    width = dec.get_bits(16)
    height = dec.get_bits(16)
    has_alpha = bool(dec.get_bit())
    use_dct = bool(dec.get_bits(1))
    int_q = dec.get_bits(8) if use_dct else 0
    dct_q = int_q / 2.0
    if use_dct and not (0.0 < dct_q <= 100.0):
        raise ValueError("invalid XUASTC DCT quality")

    trial_modes = XT.encoder_trial_modes(bsi)
    groups = _grouped_trial_modes(bsi)
    nbx = (width + bw - 1) // bw
    nby = (height + bh - 1) // bh

    # models
    mode_model = arith.DataModel(6)
    solid_dpcm = [arith.DataModel(256, faster_update=True) for _ in range(4)]
    raw_ep_models = [arith.DataModel(ah.ise_levels(r))
                     for r in range(4, 21)]
    dpcm_ep_models = [arith.DataModel(ah.ise_levels(r))
                      for r in range(4, 21)]
    is_base_ofs_model = arith.BitModel()
    use_dct_models = [arith.BitModel() for _ in range(4)]
    use_dpcm_model = arith.BitModel()
    cem_index_models = [arith.DataModel(14) for _ in range(8)]
    subset_models = [arith.DataModel(3) for _ in range(3)]
    ccs_models = [arith.DataModel(5) for _ in range(5)]
    grid_size_models = [arith.DataModel(2) for _ in range(2)]
    grid_aniso_models = [arith.DataModel(3) for _ in range(3)]
    submode_models = {}
    bc_models = [arith.BitModel() for _ in range(4)]
    ep_reuse_model = arith.DataModel(len(REUSE_XY_DELTAS))
    cfg_reuse_models = [arith.DataModel(4) for _ in range(4)]
    run_ctxs = arith.GammaContexts()
    use_part_hash_models = [arith.BitModel() for _ in range(4)]
    part2_hash_model = arith.DataModel(XT.PART_HASH_SIZE, faster_update=True)
    part3_hash_model = arith.DataModel(XT.PART_HASH_SIZE, faster_update=True)
    if not fast:
        dct_run_model = arith.DataModel(65)
        dct_coeff_model = arith.DataModel(255)
        mean_models = [arith.DataModel(XD.DCT_MEAN_LEVELS0),
                       arith.DataModel(XD.DCT_MEAN_LEVELS1)]
        raw_weight_models = [arith.DataModel(ah.ise_levels(r))
                             for r in range(0, 12)]

    part2_hash = [-1] * XT.PART_HASH_SIZE
    part3_hash = [-1] * XT.PART_HASH_SIZE

    _CEM_TO_LDRCEM = {0: 0, 4: 1, 6: 2, 8: 3, 9: 4, 10: 5, 12: 6, 13: 7}

    class _State:
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

    log_ring = [[None] * nbx for _ in range(8)]
    st_ring = [[None] * nbx for _ in range(2)]
    out = []
    cur_run_len = 0

    def emit(bx, by, blk):
        out.append(blk)
        log_ring[by & 7][bx] = blk

    for by in range(nby):
        for bx in range(nbx):
            left = st_ring[by & 1][bx - 1] if bx else None
            up = st_ring[(by - 1) & 1][bx] if by else None
            diag = st_ring[(by - 1) & 1][bx - 1] if (bx and by) else None
            pred = left if left is not None else up
            ns = _State()
            st_ring[by & 1][bx] = ns

            if cur_run_len:
                prev_blk = log_ring[by & 7][bx - 1] if bx \
                    else log_ring[(by - 1) & 7][bx]
                prev_st = left if left is not None else up
                emit(bx, by, prev_blk)
                _copy_state(ns, prev_st, reused=True)
                cur_run_len -= 1
                continue

            mode_index = dec.decode_sym(mode_model)

            if mode_index == 0:                           # SOLID
                prev_blk = (log_ring[by & 7][bx - 1] if bx else
                            (log_ring[(by - 1) & 7][bx] if by else None))
                prev_c = [0, 0, 0, 0]
                if prev_blk is not None:
                    if prev_blk.solid_ldr:
                        prev_c = [v >> 8 for v in prev_blk.solid_color]
                    else:
                        pl, ph = XC.decode_endpoints(
                            prev_blk.cems[0], prev_blk.endpoints,
                            prev_blk.endpoint_ise_range)
                        prev_c = [(pl[i] + ph[i] + 1) >> 1 for i in range(4)]
                r = (prev_c[0] + dec.decode_sym(solid_dpcm[0])) & 0xFF
                g = (prev_c[1] + dec.decode_sym(solid_dpcm[1])) & 0xFF
                b = (prev_c[2] + dec.decode_sym(solid_dpcm[2])) & 0xFF
                a = 255
                if has_alpha:
                    a = (prev_c[3] + dec.decode_sym(solid_dpcm[3])) & 0xFF
                blk = ah.LogBlock(
                    solid_ldr=True,
                    solid_color=(r | (r << 8), g | (g << 8),
                                 b | (b << 8), a | (a << 8)))
                emit(bx, by, blk)
                ns.used_dct = bool(use_dct)
                ns.uses_bc = True
                ns.was_solid = True
                ns.tm_index = -1
                ns.base_cem = 8
                ns.used_part_hash = True
                continue

            if mode_index == 5:                           # RUN
                if not bx and not by:
                    raise ValueError("XUASTC arith run at origin")
                cur_run_len = dec.decode_gamma(run_ctxs)
                if not cur_run_len or cur_run_len > nbx - bx:
                    raise ValueError("XUASTC arith invalid run")
                prev_blk = log_ring[by & 7][bx - 1] if bx \
                    else log_ring[(by - 1) & 7][bx]
                prev_st = left if left is not None else up
                emit(bx, by, prev_blk)
                _copy_state(ns, prev_st, reused=True)
                cur_run_len -= 1
                continue

            blk = ah.LogBlock()
            tm_index = 0
            actual_cem = 0

            if mode_index != 1:                           # REUSE CFG+EP
                cfg_st, cfg_blk = _neighbor(mode_index - 2, bx, by,
                                            left, up, diag, log_ring, nbx)
                if cfg_st is None or cfg_st.tm_index < 0:
                    raise ValueError("XUASTC arith invalid reuse")
                tm_index = cfg_st.tm_index
                actual_cem = cfg_blk.cems[0]
                blk.cems = (actual_cem,) * cfg_blk.num_partitions
                blk.dual_plane = cfg_blk.dual_plane
                blk.ccs = cfg_blk.ccs
                blk.num_partitions = cfg_blk.num_partitions
                blk.partition_id = cfg_blk.partition_id
                blk.endpoint_ise_range = cfg_blk.endpoint_ise_range
                blk.weight_ise_range = cfg_blk.weight_ise_range
                blk.grid_width = cfg_blk.grid_width
                blk.grid_height = cfg_blk.grid_height
                nvals = XT.cem_num_values(actual_cem)
                blk.endpoints = list(
                    cfg_blk.endpoints[:nvals * blk.num_partitions])
                _copy_cfg_state(ns, cfg_st)
                if actual_cem in XT.CEMS_SUPPORT_BC:
                    ns.uses_bc = XC.used_blue_contraction(
                        actual_cem, blk.endpoints, blk.endpoint_ise_range)
            else:                                         # RAW
                ridx = (1 if left is None else int(left.reused_cfg)) \
                    | ((1 if up is None else int(up.reused_cfg)) << 1)
                cfg_reuse = dec.decode_sym(cfg_reuse_models[ridx])
                if cfg_reuse < 3:
                    cfg_st, cfg_blk = _neighbor(cfg_reuse, bx, by,
                                                left, up, diag, log_ring,
                                                nbx)
                    if cfg_st is None or cfg_st.tm_index < 0:
                        raise ValueError("XUASTC arith invalid cfg reuse")
                    tm_index = cfg_st.tm_index
                    blk.partition_id = cfg_blk.partition_id
                    actual_cem = cfg_blk.cems[0]
                    _copy_cfg_state(ns, cfg_st)
                else:
                    prev_cem, prev_sub, prev_ccs = 8, 0, 0
                    prev_gs, prev_ga = 0, 0
                    if pred is not None:
                        prev_cem = pred.base_cem
                        prev_sub = pred.subset
                        prev_ccs = pred.ccs
                        prev_gs = pred.grid_size
                        prev_ga = pred.grid_aniso
                    ldrcem = _CEM_TO_LDRCEM[prev_cem]
                    cem_index = dec.decode_sym(cem_index_models[ldrcem])
                    subset_index = dec.decode_sym(subset_models[prev_sub])
                    ccs_index = dec.decode_sym(ccs_models[prev_ccs])
                    gs_index = dec.decode_sym(grid_size_models[prev_gs])
                    ga_index = dec.decode_sym(grid_aniso_models[prev_ga])
                    modes = groups.get(
                        (cem_index, subset_index, ccs_index, gs_index,
                         ga_index), [])
                    submode = 0
                    if len(modes) > 1:
                        key = (cem_index, subset_index, ccs_index,
                               gs_index, ga_index)
                        sm = submode_models.get(key)
                        if sm is None:
                            sm = arith.DataModel(len(modes),
                                                 faster_update=True)
                            submode_models[key] = sm
                        submode = dec.decode_sym(sm)
                    if submode >= len(modes):
                        raise ValueError("XUASTC arith invalid submode")
                    tm_index = modes[submode]
                    ns.tm_index = tm_index
                    ns.base_cem = cem_index
                    ns.subset = subset_index
                    ns.ccs = ccs_index
                    ns.grid_size = gs_index
                    ns.grid_aniso = ga_index
                    ns.reused_cfg = False

                    tm = trial_modes[tm_index]
                    actual_cem = tm.cem
                    if tm.cem in (8, 12):
                        if dec.decode_bit(is_base_ofs_model):
                            actual_cem = tm.cem + 1
                    if tm.num_parts > 1:
                        total_unique = XT.get_total_unique_patterns(
                            bsi, tm.num_parts)
                        pidx = (1 if left is None else
                                int(left.used_part_hash)) \
                            | ((1 if up is None else
                                int(up.used_part_hash)) << 1)
                        phash = part2_hash if tm.num_parts == 2 \
                            else part3_hash
                        if not dec.decode_bit(use_part_hash_models[pidx]):
                            upi = dec.decode_truncated_binary(total_unique)
                            phash[XT.part_hash_index(upi)] = upi
                            ns.used_part_hash = False
                        else:
                            hidx = dec.decode_sym(
                                part2_hash_model if tm.num_parts == 2
                                else part3_hash_model)
                            upi = phash[hidx]
                            if upi < 0:
                                raise ValueError(
                                    "XUASTC arith invalid part hash")
                            ns.used_part_hash = True
                        if upi >= total_unique:
                            raise ValueError("XUASTC arith bad pattern")
                        blk.partition_id = \
                            XT.unique_pat_index_to_part_seed(
                                bsi, tm.num_parts, upi)
                    else:
                        ns.used_part_hash = True

                tm = trial_modes[tm_index]
                total_vals = XT.cem_num_values(actual_cem)
                blk.cems = (actual_cem,) * tm.num_parts
                blk.num_partitions = tm.num_parts
                blk.dual_plane = tm.ccs_index >= 0
                blk.ccs = tm.ccs_index if blk.dual_plane else 0
                blk.weight_ise_range = tm.weight_ise_range
                blk.endpoint_ise_range = tm.endpoint_ise_range
                blk.grid_width = tm.grid_width
                blk.grid_height = tm.grid_height

                if not dec.decode_bit(use_dpcm_model):
                    rm = raw_ep_models[blk.endpoint_ise_range - 4]
                    blk.endpoints = [dec.decode_sym(rm)
                                     for _ in range(tm.num_parts * total_vals)]
                else:
                    etab = XT.endpoint_tab(blk.endpoint_ise_range)
                    n_levels = etab.ise_to_val.shape[0]
                    ridx2 = dec.decode_sym(ep_reuse_model)
                    dx, dy = REUSE_XY_DELTAS[ridx2]
                    rbx, rby = bx + dx, by + dy
                    if not (0 <= rbx < nbx and 0 <= rby < nby):
                        raise ValueError("XUASTC arith bad reuse delta")
                    pred_blk = log_ring[rby & 7][rbx]
                    if pred_blk is None or pred_blk.solid_ldr:
                        raise ValueError("XUASTC arith reuse of solid")
                    bcidx = (1 if left is None else int(left.uses_bc)) \
                        | ((1 if up is None else int(up.uses_bc)) << 1)
                    use_bc = [False] * blk.num_partitions
                    if actual_cem in XT.CEMS_SUPPORT_BC:
                        for p in range(blk.num_partitions):
                            use_bc[p] = bool(
                                dec.decode_bit(bc_models[bcidx]))
                    dm = dpcm_ep_models[blk.endpoint_ise_range - 4]
                    blk.endpoints = [0] * (blk.num_partitions * total_vals)
                    for p in range(blk.num_partitions):
                        pv, _bc, _bo = XC.convert_endpoints_across_cems(
                            pred_blk.cems[0], pred_blk.endpoint_ise_range,
                            pred_blk.endpoints,
                            actual_cem, blk.endpoint_ise_range,
                            False, use_bc[p], False)
                        for v in range(total_vals):
                            delta = dec.decode_sym(dm)
                            e_val = (delta
                                     + int(etab.ise_to_rank[pv[v]])) \
                                % n_levels
                            blk.endpoints[p * total_vals + v] = int(
                                etab.rank_to_ise[e_val])
                if actual_cem in XT.CEMS_SUPPORT_BC:
                    ns.uses_bc = XC.used_blue_contraction(
                        actual_cem, blk.endpoints, blk.endpoint_ise_range)

            # --- weights
            tm = trial_modes[tm_index]
            total_planes = 2 if tm.ccs_index >= 0 else 1
            total_weights = tm.grid_width * tm.grid_height
            blk.weights = [0] * (total_weights * total_planes)

            didx = 0
            if use_dct:
                didx = (1 if left is None else int(left.used_dct)) \
                    | ((1 if up is None else int(up.used_dct)) << 1)
            block_used_dct = bool(use_dct
                                  and dec.decode_bit(use_dct_models[didx]))
            if block_used_dct:
                ns.used_dct = True
                num_dc_levels = XD.get_num_weight_dc_levels(
                    blk.weight_ise_range)
                spans = XD.get_max_span_len(blk, XC)
                for plane in range(total_planes):
                    if fast:
                        if num_dc_levels == XD.DCT_MEAN_LEVELS1:
                            dc_sym = mean1.get(8)
                        else:
                            dc_sym = mean0.get(4)
                    else:
                        dc_sym = dec.decode_sym(
                            mean_models[1 if num_dc_levels
                                        == XD.DCT_MEAN_LEVELS1 else 0])
                    coeffs = []
                    cur_zig = 1
                    while cur_zig < total_weights:
                        if fast:
                            run_len = run_bytes.get(8)
                        else:
                            run_len = dec.decode_sym(dct_run_model)
                        if run_len == XD.DCT_RUN_LEN_EOB_SYM_INDEX:
                            break
                        cur_zig += run_len
                        if cur_zig >= total_weights:
                            raise ValueError("XUASTC arith DCT error")
                        if fast:
                            sign = sign_bits.get(1)
                            coeff = coeff_bytes.get(8) + 1
                        else:
                            sign = dec.get_bit()
                            coeff = dec.decode_sym(dct_coeff_model) + 1
                        if sign:
                            coeff = -coeff
                        coeffs.append((run_len, coeff))
                        cur_zig += 1
                    XD.decode_block_weights_from_syms(
                        dct_q, plane, blk, bw, bh, dc_sym, coeffs,
                        spans[plane])
            else:
                wtab = XT.weight_tab(blk.weight_ise_range)
                n_levels = int(wtab.ise_to_val.shape[0])
                for plane in range(total_planes):
                    prev_w = n_levels // 2
                    for _wi in range(total_weights):
                        if fast:
                            if n_levels <= 4:
                                r = w2.get(2)
                            elif n_levels <= 8:
                                r = w3.get(4)
                            elif n_levels <= 16:
                                r = w4.get(4)
                            else:
                                r = w8.get(8)
                        else:
                            r = dec.decode_sym(
                                raw_weight_models[blk.weight_ise_range])
                        wv = (prev_w + r) % n_levels
                        prev_w = wv
                        blk.weights[plane + _wi * total_planes] = int(
                            wtab.rank_to_ise[wv])

            emit(bx, by, blk)
            ns.tm_index = tm_index

    if dec.get_bits(8) != 0xAF:
        raise ValueError("XUASTC arith final sync failed")

    c = XuastcContainer(
        syntax=syntax, block_w=bw, block_h=bh, width=width, height=height,
        has_alpha=has_alpha, srgb_decode=srgb, use_dct=use_dct, dct_q=dct_q,
        raw_bits=b"", raw_bits_start_bit=0, streams={})
    return c, out


def _copy_state(ns, prev, reused: bool):
    """RUN continuation: the full neighbor state carries over."""
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
    """Config reuse: only the configuration fields carry over; DCT/BC flags
    are recomputed for this block (basisu_transcoder.cpp:29103-29110)."""
    ns.reused_cfg = True
    ns.tm_index = prev.tm_index
    ns.base_cem = prev.base_cem
    ns.subset = prev.subset
    ns.ccs = prev.ccs
    ns.grid_size = prev.grid_size
    ns.grid_aniso = prev.grid_aniso
    ns.used_part_hash = prev.used_part_hash


def _neighbor(which: int, bx: int, by: int, left, up, diag, log_ring, nbx):
    if which == 0:
        return (left, log_ring[by & 7][bx - 1] if bx else None)
    if which == 1:
        return (up, log_ring[(by - 1) & 7][bx] if by else None)
    return (diag, log_ring[(by - 1) & 7][bx - 1] if (bx and by) else None)


import functools as _functools


@_functools.lru_cache(maxsize=None)
def _grouped_trial_modes(block_size_index: int):
    """grouped_trial_modes analog: buckets keyed by
    (cem, subsets-1, ccs+1, grid_size, grid_aniso) holding tm indices in
    table order (basisu_transcoder_internal.h:2066)."""
    from . import xuastc_tables as XT

    bw, bh = XT.ASTC_BLOCK_SIZES[block_size_index]
    groups = {}
    for i, t in enumerate(XT.encoder_trial_modes(block_size_index)):
        grid_size = int(t.grid_width >= bw - 1 and t.grid_height >= bh - 1)
        lhs = t.grid_width * bh
        rhs = t.grid_height * bw
        aniso = 0 if lhs == rhs else (1 if lhs >= rhs else 2)
        key = (t.cem, t.num_parts - 1, t.ccs_index + 1, grid_size, aniso)
        groups.setdefault(key, []).append(i)
    return groups


def probe_block_size(data: bytes):
    """Cheap header probe → (block_w, block_h) for any syntax."""
    syntax = data[0] & 3
    if syntax == SYNTAX_FULL_ZSTD:
        import struct

        lens = struct.unpack_from("<21I", data, 1)
        raw = _RawBits(data[1 + 21 * 4:1 + 21 * 4 + min(lens[0], 16)])
        if raw.get(5) != 0x01:
            raise ValueError("bad XUASTC marker")
        return ASTC_BLOCK_SIZES[raw.get(4)]
    from ...entropy import arith

    if syntax == SYNTAX_HYBRID_ARITH_ZSTD:
        import struct

        ln = struct.unpack_from("<I", data, 1)[0]
        dec = arith.ArithDecoder(data[45:45 + min(ln, 64)])
    else:
        dec = arith.ArithDecoder(data[1:65])
    if dec.get_bits(5) != 0x01:
        raise ValueError("bad XUASTC arith marker")
    return ASTC_BLOCK_SIZES[dec.get_bits(4)]


def decode_any(data: bytes):
    """Decode any XUASTC LDR syntax → (container, LogBlock list)."""
    syntax = data[0] & 3
    if syntax == SYNTAX_FULL_ZSTD:
        return decode_log_blocks(data)
    return decode_log_blocks_arith(data)


def decode_rgba(data: bytes):
    """XUASTC LDR (any syntax) → (H, W, 4) uint8 RGBA."""
    import numpy as np

    from . import helpers as ah

    c, blocks = decode_any(data)
    nbx = (c.width + c.block_w - 1) // c.block_w
    nby = (c.height + c.block_h - 1) // c.block_h
    out = np.zeros((nby * c.block_h, nbx * c.block_w, 4), dtype=np.uint8)
    for i, blk in enumerate(blocks):
        by, bx = divmod(i, nbx)
        px = ah.decode_block(blk, c.block_w, c.block_h,
                             srgb=c.srgb_decode)
        out[by * c.block_h:(by + 1) * c.block_h,
            bx * c.block_w:(bx + 1) * c.block_w] = np.asarray(
                px, dtype=np.uint8).reshape(c.block_h, c.block_w, 4)
    return c, out[:c.height, :c.width]


def decode_astc_physical(data: bytes):
    """XUASTC LDR (any syntax) → (N, 16) uint8 physical ASTC blocks."""
    from .hdr6x6_decode import pack_log_blocks

    c, blocks = decode_any(data)
    return c, pack_log_blocks(blocks)
