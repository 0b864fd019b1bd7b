"""Copy of `basis_universal_tpu/codecs/astc/hdr6x6_decode.py`.

UASTC HDR 6x6 INTERMEDIATE decode → logical ASTC blocks → pixels.

The intermediate format (parity: transcoder/basisu_transcoder.cpp
decode_6x6_hdr:24770 and the astc_6x6_hdr namespace in
basisu_astc_hdr_core.h) is a bitwise stream of per-block encodings:
  RUN   (code 000): repeat the previous block
  SOLID (code 100): 3x15-bit positive half floats
  REUSE (code  10): copy a nearby block's mode/endpoints, new weights
  BLOCK (code   1): truncated-binary block mode (75 modes) + endpoint
        mode (raw / use-left / use-upper / ±5-bit rank deltas) +
        ISE-coded endpoints and weights (trit/quint bits packed FIRST,
        then the plain bits — NOT standard ASTC ISE interleaving)
followed by a 0xA742 end marker.  Decoded blocks are standard ASTC HDR
6x6 (CEM 7/11) after requantizing endpoints/weights from the coding ISE
ranges to the transcode ranges; a 2x2 weight grid is upsampled to 4x4
(not valid ASTC otherwise).
"""

import functools

import numpy as np

from ..uastc import tables as T
from . import helpers as ah
from . import hdr6x6_tables as HT

SIG0 = 0xABCD  # original release (encoder bug in 2x2 upsample)
SIG1 = 0xABCE
END_MARKER = 0xA742
REUSE_ROWS = 5


class _BitReader:
    """LSB-first bit reader (bitwise_decoder semantics)."""

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

    def vlc(self, chunk_bits: int) -> int:
        mask = (1 << chunk_bits) - 1
        v = 0
        ofs = 0
        while True:
            s = self.get(chunk_bits + 1)
            v |= (s & mask) << ofs
            ofs += chunk_bits
            if not (s & (1 << chunk_bits)):
                return v

    def truncated_binary(self, n: int) -> int:
        k = n.bit_length() - 1
        u = (1 << (k + 1)) - n
        r = self.get(k)
        if r >= u:
            r = ((r << 1) | self.get(1)) - u
        return r


@functools.lru_cache(maxsize=None)
def _weight_tabs(rng: int):
    levels = ah.ise_levels(rng)
    ise_to_val = np.array([ah.dequant_weight(v, rng) for v in range(levels)])
    val_to_ise = np.array(
        [int(np.argmin(np.abs(ise_to_val - v))) for v in range(65)])
    return ise_to_val, val_to_ise


@functools.lru_cache(maxsize=None)
def _endpoint_tabs(rng: int):
    ise_to_val = np.asarray(T.color_unquant_table(rng), dtype=np.int64)
    val_to_ise = np.array(
        [int(np.argmin(np.abs(ise_to_val - v))) for v in range(256)])
    order = np.argsort(ise_to_val * 256 + np.arange(len(ise_to_val)))
    rank_to_ise = order.astype(np.int64)
    ise_to_rank = np.zeros_like(rank_to_ise)
    ise_to_rank[rank_to_ise] = np.arange(len(rank_to_ise))
    return ise_to_val, val_to_ise, ise_to_rank, rank_to_ise


@functools.lru_cache(maxsize=None)
def _preserve_tab(rng: int, top_bits: int):
    """quantize [0,255] to the nearest ISE symbol whose dequantized value
    preserves the top 2/3 bits (init_quantize_tables:23008)."""
    ise_to_val, _, _, _ = _endpoint_tabs(rng)
    mask = 0b11000000 if top_bits == 2 else 0b11100000
    out = np.zeros(256, dtype=np.int64)
    for v in range(256):
        best, best_err = -1, 1 << 30
        for sym, qv in enumerate(ise_to_val):
            if (qv & mask) != (v & mask):
                continue
            err = (int(qv) - v) ** 2
            if err < best_err:
                best_err, best = err, sym
        out[v] = best
    return out


def _decode_values(br: _BitReader, total: int, rng: int) -> list:
    """The intermediate ISE layout: all trit/quint packed words first."""
    b, t, q = ah.BISE_RANGE_TABLE[rng]
    tq_vals = []
    if t or q:
        bundle = 5 if t else 3
        mul = 3 if t else 5
        n_tq = -(-total // bundle)
        for i in range(n_tq):
            nb = 8 if t else 7
            if i == n_tq - 1:
                rem = total - (n_tq - 1) * bundle
                if t:
                    nb = {1: 2, 2: 4, 3: 5, 4: 7}.get(rem, 8)
                else:
                    nb = {1: 3, 2: 5}.get(rem, 7)
            tq_vals.append(br.get(nb))
    else:
        bundle = mul = 0
    out = []
    accum = 0
    accum_rem = 0
    nxt = 0
    for _ in range(total):
        v = br.get(b) if b else 0
        if tq_vals:
            if not accum_rem:
                accum = tq_vals[nxt]
                nxt += 1
                accum_rem = bundle
            v |= (accum % mul) << b
            accum //= mul
            accum_rem -= 1
        out.append(v)
    return out


def _requant_weights(vals, from_r: int, to_r: int):
    if from_r == to_r:
        return list(vals)
    dq, _ = _weight_tabs(from_r)
    _, q = _weight_tabs(to_r)
    return [int(q[dq[v]]) for v in vals]


def _requant_endpoints(cem: int, vals, from_r: int, to_r: int):
    """requantize_ise_endpoints (:23089) incl. the MSB-preserving tables
    for CEM 11 non-direct and CEM 7."""
    n = 6 if cem == 11 else 4
    if from_r == to_r:
        return list(vals[:n])
    dq_src, _, _, _ = _endpoint_tabs(from_r)
    raw = [int(dq_src[v]) for v in vals[:n]] if from_r != 20 \
        else [int(v) for v in vals[:n]]
    if to_r == 20:
        return raw
    _, q, _, _ = _endpoint_tabs(to_r)
    p2 = _preserve_tab(to_r, 2)
    p3 = _preserve_tab(to_r, 3)
    if cem == 11:
        maj = ((raw[4] >> 7) & 1) | (((raw[5] >> 7) & 1) << 1)
        if maj == 3:  # direct
            return [int(q[v]) for v in raw]
        return [int(q[raw[0]]), int(p2[raw[1]]), int(p2[raw[2]]),
                int(p2[raw[3]]), int(p3[raw[4]]), int(p3[raw[5]])]
    return [int(p2[raw[0]]), int(p3[raw[1]]), int(p3[raw[2]]),
            int(p3[raw[3]])]


@functools.lru_cache(maxsize=None)
def _upsample_4x4_from_2x2_samples():
    """compute_upsample_weights(4,4,2,2): per dst texel (jX, jY,
    w[yo][xo]) bilinear taps scaled by 16 (basisu_astc_helpers.h:1780)."""
    scale = (1024 + 2) // 3
    out = []
    for ty in range(4):
        for tx in range(4):
            gx = (scale * tx * 1 + 32) >> 6
            gy = (scale * ty * 1 + 32) >> 6
            jx, fx = gx >> 4, gx & 0xF
            jy, fy = gy >> 4, gy & 0xF
            w11 = (fx * fy + 8) >> 4
            w10 = fy - w11
            w01 = fx - w11
            w00 = 16 - fx - fy + w11
            out.append((jx, jy, ((w00, w01), (w10, w11))))
    return tuple(out)


def _make_log_block(bmd, endpoints, weights, partition_id: int,
                    orig_2x2: bool = False):
    """Build our decoder's LogBlock at the mode's TRANSCODE ISE ranges."""
    (dp, cem, nparts, gx, gy, _er, wr, te_r, tw_r, _lv, dpc) = bmd
    blk = ah.LogBlock()
    blk.dual_plane = bool(dp)
    blk.ccs = max(dpc, 0)
    blk.num_partitions = nparts
    blk.partition_id = partition_id
    blk.cems = tuple([cem] * nparts)
    blk.endpoint_ise_range = te_r
    blk.grid_width = gx
    blk.grid_height = gy
    blk.weight_ise_range = tw_r
    blk.endpoints = list(endpoints)
    if (not dp) and gx == 2 and gy == 2:
        # 2x2 isn't valid ASTC: upsample the grid to 4x4 (copy_weight_grid,
        # basisu_transcoder.cpp:23205-23257)
        dqw, qw = _weight_tabs(tw_r)
        blk.grid_width = 4
        blk.grid_height = 4
        if orig_2x2:
            # SIG0 streams: the original release's upsample indexed the
            # source grid by a BOOL bounds test, always sampling weight 0
            # or 1 — harmless but divergent, so SIG0 decode must reproduce
            # it exactly (basisu_transcoder.cpp:23235-23240)
            up = []
            for dy in range(4):
                for dx in range(4):
                    _jx, _jy, w = _upsample_4x4_from_2x2_samples()[dx + dy * 4]
                    total = 8
                    for yo in range(2):
                        for xo in range(2):
                            if not w[yo][xo]:
                                continue
                            idx = 1 if (dx + xo) + (dy + yo) * 2 < 4 else 0
                            total += int(dqw[weights[idx]]) * w[yo][xo]
                    up.append(total >> 4)
        else:
            dq = [int(dqw[v]) for v in weights]
            up = ah.upsample_weights(dq, 2, 2, 4, 4)
        blk.weights = [int(qw[v]) for v in up]
    else:
        blk.weights = list(weights)
    return blk


def decode_6x6_hdr(data: bytes, trace=None):
    """Intermediate stream → (list of LogBlocks raster order, width,
    height).  Raises ValueError on malformed streams. trace (optional
    list) receives one (entry_type, extra) per block for debugging."""
    br = _BitReader(data)
    sig = br.get(16)
    if sig not in (SIG0, SIG1):
        raise ValueError("bad UASTC HDR 6x6 intermediate signature")
    orig_2x2 = sig == SIG0
    width = br.get(16)
    height = br.get(16)
    if not width or not height:
        raise ValueError("bad dimensions")
    nbx, nby = -(-width // 6), -(-height // 6)
    total = nbx * nby
    blocks = [None] * total
    # log-block reuse window (mode/endpoint state at CODING ranges)
    state = [None] * total  # (bmd_index, endpoint_ise_range, endpoints)

    i = 0
    while i < total:
        b0 = br.get(1)
        if b0:
            et = "block"
        elif br.get(1):
            et = "reuse"
        elif br.get(1):
            et = "solid"
        else:
            et = "run"

        if et == "run":
            if i == 0:
                raise ValueError("run at start")
            run_len = br.vlc(5) + 1
            if run_len > total - i:
                raise ValueError("run too long")
            for _ in range(run_len):
                blocks[i] = blocks[i - 1]
                state[i] = state[i - 1]
                if trace is not None:
                    trace.append(("run", None))
                i += 1
        elif et == "solid":
            rh, gh, bh = br.get(15), br.get(15), br.get(15)
            blk = ah.LogBlock()
            blk.solid_hdr = True
            blk.solid_ldr = False
            blk.solid_color = (rh, gh, bh, 0x3C00)
            blocks[i] = blk
            state[i] = None
            if trace is not None:
                trace.append(("solid", None))
            i += 1
        elif et == "reuse":
            if i == 0:
                raise ValueError("reuse at start")
            dx, dy = HT.REUSE_XY_DELTAS[br.get(5)]
            bx, by = i % nbx, i // nbx
            px, py = bx + dx, by + dy
            j = px + py * nbx
            if px < 0 or px >= nbx or py < 0 or j >= i:
                raise ValueError("bad reuse target")
            if state[j] is None:
                raise ValueError("reuse of solid block")
            bmd_i, ep_rng, eps = state[j][:3]
            bmd = HT.BLOCK_MODE_DESCS[bmd_i]
            (dp, cem, nparts, gx, gy, _er, wr, te_r, tw_r, _lv, _c) = bmd
            nw = gx * gy * (2 if dp else 1)
            weights = _decode_values(br, nw, wr)
            nvals = 6 if cem == 11 else 4
            t_eps = []
            pid = state[j][3] if len(state[j]) > 3 else 0
            for p in range(nparts):
                t_eps += _requant_endpoints(
                    cem, eps[nvals * p:nvals * (p + 1)], ep_rng, te_r)
            t_w = _requant_weights(weights, wr, tw_r)
            blocks[i] = _make_log_block(bmd, t_eps, t_w, pid, orig_2x2)
            state[i] = (bmd_i, ep_rng, eps, pid)
            if trace is not None:
                trace.append(("reuse", (dx, dy, bmd_i)))
            i += 1
        else:  # block
            bm = br.truncated_binary(len(HT.BLOCK_MODE_DESCS))
            em = br.truncated_binary(5)
            bmd = HT.BLOCK_MODE_DESCS[bm]
            (dp, cem, nparts, gx, gy, e_r, w_r, te_r, tw_r, _lv, _c) = bmd
            nvals = 6 if cem == 11 else 4
            bx, by = i % nbx, i // nbx
            pid = 0
            if em == 0:  # raw
                if nparts == 2:
                    pid = HT.PART2_UNIQUE_INDEX_TO_SEED[
                        br.truncated_binary(len(HT.PART2_UNIQUE_INDEX_TO_SEED))]
                elif nparts == 3:
                    pid = HT.PART3_UNIQUE_INDEX_TO_SEED[
                        br.truncated_binary(len(HT.PART3_UNIQUE_INDEX_TO_SEED))]
                eps = _decode_values(br, nvals * nparts, e_r)
                ep_rng = e_r
            else:
                nx, ny = (bx - 1, by) if em in (1, 3) else (bx, by - 1)
                if nx < 0 or ny < 0:
                    raise ValueError("bad neighbor")
                j = nx + ny * nbx
                if state[j] is None:
                    raise ValueError("neighbor is solid")
                n_bmd_i, n_rng, n_eps = state[j][:3]
                n_cem = HT.BLOCK_MODE_DESCS[n_bmd_i][1]
                if n_cem != cem:
                    raise ValueError("neighbor CEM mismatch")
                if em in (1, 2):  # use left/upper verbatim
                    ep_rng = n_rng
                    eps = list(n_eps[:nvals])
                else:  # ±rank delta at the mode's coding range
                    ep_rng = e_r
                    base = _requant_endpoints(cem, n_eps[:nvals], n_rng, e_r)
                    _, _, ise_to_rank, rank_to_ise = _endpoint_tabs(e_r)
                    levels = ah.ise_levels(e_r)
                    eps = []
                    for k in range(nvals):
                        delta = br.get(5) - 16
                        r = int(ise_to_rank[base[k]]) + delta
                        if r < 0 or r >= levels:
                            raise ValueError("endpoint delta out of range")
                        eps.append(int(rank_to_ise[r]))
            nw = gx * gy * (2 if dp else 1)
            weights = _decode_values(br, nw, w_r)
            t_eps = []
            for p in range(nparts):
                t_eps += _requant_endpoints(
                    cem, eps[nvals * p:nvals * (p + 1)], ep_rng, te_r)
            t_w = _requant_weights(weights, w_r, tw_r)
            blocks[i] = _make_log_block(bmd, t_eps, t_w, pid, orig_2x2)
            state[i] = (bm, ep_rng, eps, pid)
            if trace is not None:
                trace.append(("block", (em, bm)))
            i += 1

    if br.get(16) != END_MARKER:
        raise ValueError("end marker missing")
    return blocks, width, height


def decode_blocks_rgba16f(data: bytes):
    """Intermediate stream → ((nby*nbx, 6, 6, 4) half bits, w, h)."""
    blocks, w, h = decode_6x6_hdr(data)
    out = np.zeros((len(blocks), 6, 6, 4), dtype=np.uint16)
    for i, blk in enumerate(blocks):
        out[i] = ah.decode_block(blk, 6, 6)
    return out, w, h


# --- generic logical → physical ASTC pack ------------------------------------


def pack_log_block(blk) -> bytes:
    """LogBlock → 16-byte physical ASTC block (single-CEM configs; the
    endpoint ISE range must equal the decoder-inferred range, as all
    valid ASTC encodings do).  astc_helpers::pack_astc_block analog."""
    from ..uastc import astc_pack

    if blk.solid_hdr or blk.solid_ldr:
        w = astc_pack._BlockWriter()
        w.put(0b111111100, 9)
        w.put(1 if blk.solid_hdr else 0, 1)
        w.put(0b11, 2)
        for _ in range(4):
            w.put(0x1FFF, 13)
        for c in range(4):
            w.put_at(int(blk.solid_color[c]), 16, 64 + 16 * c)
        return w.to_bytes()

    from .hdr_encode import _block_mode_table

    w = astc_pack._BlockWriter()
    bm = _block_mode_table().get(
        (blk.grid_width, blk.grid_height, blk.weight_ise_range,
         bool(blk.dual_plane)))
    if bm is None:
        raise ValueError("no block mode for config")
    w.put(bm, 11)
    w.put(blk.num_partitions - 1, 2)
    cem = blk.cems[0]
    extra_bits = 0
    if blk.num_partitions == 1:
        w.put(cem, 4)
        config_bits = 17
    else:
        w.put(blk.partition_id, 10)
        w.put(cem << 2, 6)  # all-same-CEM encoding
        config_bits = 11 + 2 + 16
    nw = blk.grid_width * blk.grid_height * (2 if blk.dual_plane else 1)
    wbits = ah.ise_sequence_bits(nw, blk.weight_ise_range)
    if blk.dual_plane:
        extra_bits = 2
        w.put_at(blk.ccs, 2, 128 - wbits - 2)
    n_vals = ah.cem_num_values(cem) * blk.num_partitions
    remaining = 128 - config_bits - wbits - extra_bits
    inferred = -1
    for k in range(20, 3, -1):
        if ah.ise_sequence_bits(n_vals, k) <= remaining:
            inferred = k
            break
    if inferred != blk.endpoint_ise_range:
        raise ValueError(
            f"endpoint range {blk.endpoint_ise_range} != inferred {inferred}")
    astc_pack._ise_encode(w, [int(v) for v in blk.endpoints], inferred)

    # weights: ISE-encode then bit-reverse into the top of the block
    ww = astc_pack._BlockWriter()
    astc_pack._ise_encode(ww, [int(v) for v in blk.weights],
                          blk.weight_ise_range)
    rev = 0
    v = ww.bits
    for _ in range(wbits):
        rev = (rev << 1) | (v & 1)
        v >>= 1
    w.put_at(rev, wbits, 128 - wbits)
    return w.to_bytes()


def pack_log_blocks(blocks) -> np.ndarray:
    out = np.zeros((len(blocks), 16), dtype=np.uint8)
    for i, blk in enumerate(blocks):
        out[i] = np.frombuffer(pack_log_block(blk), dtype=np.uint8)
    return out


# --- UASTC HDR 6x6 intermediate ENCODE (v1) ----------------------------------


class _BitWriter:
    def __init__(self):
        self.bits = 0
        self.pos = 0

    def put(self, v: int, n: int):
        self.bits |= (int(v) & ((1 << n) - 1)) << self.pos
        self.pos += n

    def truncated_binary(self, v: int, n: int):
        k = n.bit_length() - 1
        u = (1 << (k + 1)) - n
        if v < u:
            self.put(v, k)
        else:
            self.put((v + u) >> 1, k)
            self.put((v + u) & 1, 1)

    def to_bytes(self) -> bytes:
        return self.bits.to_bytes((self.pos + 7) // 8, "little")


def _encode_values(bw: _BitWriter, vals, rng: int):
    """Inverse of _decode_values (trit/quint words first, then plain bits)."""
    b, t, q = ah.BISE_RANGE_TABLE[rng]
    total = len(vals)
    if t or q:
        bundle = 5 if t else 3
        mul = 3 if t else 5
        n_tq = -(-total // bundle)
        for i in range(n_tq):
            word = 0
            m = 1
            for c in range(bundle):
                k = i * bundle + c
                if k < total:
                    word += (vals[k] >> b) * m
                m *= mul
            nb = 8 if t else 7
            if i == n_tq - 1:
                rem = total - (n_tq - 1) * bundle
                if t:
                    nb = {1: 2, 2: 4, 3: 5, 4: 7}.get(rem, 8)
                else:
                    nb = {1: 3, 2: 5}.get(rem, 7)
            bw.put(word, nb)
    for v in vals:
        if b:
            bw.put(v & ((1 << b) - 1), b)


def encode_6x6_hdr(px_half: np.ndarray, width: int, height: int,
                   effort: int = 1, quality: int = 100) -> bytes:
    """(B,36,3) uint16 half bits (raster 6x6 blocks) → intermediate stream.

    Blocks come from the shared multi-mode planner
    (hdr_encode.plan_blocks_hdr_6x6: CEM 11 submodes + CEM 7 across the
    1-partition block-mode set). The stream uses the full cheap-block
    vocabulary: RUN for repeats, SOLID for flat blocks, REUSE when a
    window neighbor shares (mode, endpoints), BLOCK(cRaw) otherwise.
    quality < 100 runs the RDO pass first (reuse-with-refit within a
    lambda-scaled error budget — the reference's rate lever,
    encoder/basisu_astc_hdr_6x6_enc.h:16-121)."""
    from .hdr_encode import plan_blocks_hdr_6x6, _rdo_reuse_6x6i

    b = px_half.shape[0]
    nbx = -(-width // 6)
    plan = plan_blocks_hdr_6x6(px_half, effort)
    solid = (px_half.max(axis=1) == px_half.min(axis=1)).all(-1)
    if quality < 100:
        # full-copy first (enables RUN records), then endpoint reuse
        _rdo_reuse_6x6i(plan, px_half, quality, nbx, solid, refit=False)
        _rdo_reuse_6x6i(plan, px_half, quality, nbx, solid, refit=True)

    # delta index lookup for the REUSE window
    delta_index = {d: k for k, d in enumerate(HT.REUSE_XY_DELTAS)}

    desc = plan["desc"]
    eps = plan["ep_codes"]
    wcodes = plan["w_codes"]

    def cfg_key(i):
        return (int(desc[i]), eps[i].tobytes())

    bw = _BitWriter()
    bw.put(SIG1, 16)
    bw.put(width, 16)
    bw.put(height, 16)
    prev_key = None
    run_len = 0

    def flush_run():
        nonlocal run_len
        if run_len:
            bw.put(0b000, 3)
            v = run_len - 1
            while True:                                  # vlc(5)
                chunk = v & 31
                v >>= 5
                bw.put(chunk | (32 if v else 0), 6)
                if not v:
                    break
            run_len = 0

    solid_i = set(np.flatnonzero(solid).tolist())
    keys = [None] * b
    for i in range(b):
        if i in solid_i:
            keys[i] = ("s", int(px_half[i, 0, 0]), int(px_half[i, 0, 1]),
                       int(px_half[i, 0, 2]))
        else:
            (_dp, cem, _np, gx, gy, e_r, w_r, _te, _tw, _lv, _c) = \
                HT.BLOCK_MODE_DESCS[int(desc[i])]
            nv = 6 if cem == 11 else 4
            keys[i] = ("b", int(desc[i]), eps[i, :nv].tobytes(),
                       wcodes[i, :gx * gy].tobytes())

    for i in range(b):
        if i and keys[i] == prev_key:
            run_len += 1
            continue
        flush_run()
        prev_key = keys[i]
        if i in solid_i:
            bw.put(0b100, 3)
            for c in range(3):
                bw.put(int(px_half[i, 0, c]) & 0x7FFF, 15)
            continue
        (_dp, cem, _np, gx, gy, e_r, w_r, _te, _tw, _lv, _c) = \
            HT.BLOCK_MODE_DESCS[int(desc[i])]
        nv = 6 if cem == 11 else 4
        # REUSE: a window neighbor with the same mode + endpoint codes
        bx, by = i % nbx, i // nbx
        reuse_k = -1
        my_cfg = cfg_key(i)
        for (dx, dy), k in delta_index.items():
            px_, py_ = bx + dx, by + dy
            j = px_ + py_ * nbx
            if px_ < 0 or px_ >= nbx or py_ < 0 or j >= i or j < 0:
                continue
            if j in solid_i or keys[j][0] != "b":
                continue
            if cfg_key(j) == my_cfg:
                reuse_k = k
                break
        if reuse_k >= 0:
            bw.put(0b10, 2)                          # REUSE
            bw.put(reuse_k, 5)
            _encode_values(bw, [int(v) for v in wcodes[i, :gx * gy]], w_r)
            continue
        bw.put(1, 1)                                 # BLOCK
        bw.truncated_binary(int(desc[i]), len(HT.BLOCK_MODE_DESCS))
        bw.truncated_binary(0, 5)                    # endpoint mode cRaw
        _encode_values(bw, [int(v) for v in eps[i, :nv]], e_r)
        _encode_values(bw, [int(v) for v in wcodes[i, :gx * gy]], w_r)
    flush_run()
    bw.put(END_MARKER, 16)
    return bw.to_bytes()
