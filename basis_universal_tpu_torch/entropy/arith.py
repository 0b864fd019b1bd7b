"""Copy of `basis_universal_tpu/entropy/arith.py`.

Binary adaptive arithmetic coder (encoder + decoder).

Bitstream-compatible with the reference's XUASTC range coder
(transcoder/basisu_transcoder_internal.h:2362-3220, namespace arith):
a carry-propagating byte-oriented range coder with

  - adaptive BIT models (arith_bit_model :2374): live 0/1 counts with a
    probability SNAPSHOT taken at geometrically-spaced update points
    (interval 4 → ×5/4, clamped to [4, 128]),
  - adaptive DATA models (arith_data_model :2463): live symbol histogram
    with a cumulative-frequency snapshot at update points (interval
    num_syms → ×5/4, clamped to [4, (num_syms+6)·8]), halving when the
    total reaches 2^15,
  - raw bits / truncated-binary / Rice / adaptive-gamma value codes.

The update rules and fixed-point scalings are format-spec material: decode
must replay the encoder's model state bit-exactly. A C++ mirror of the hot
decode loop lives in native/slice_codec.cpp (arith_* entry points) — this
module is the reference implementation and fallback.
"""

DM_LEN_SHIFT = 15
DM_MAX_COUNT = 1 << DM_LEN_SHIFT
BM_LEN_SHIFT = 13
BM_MAX_COUNT = 1 << BM_LEN_SHIFT
ARITH_MIN_LEN = 1 << 24
ARITH_MAX_LEN = 0xFFFFFFFF
ARITH_MAX_SYMS = 2048
MIN_BUF_SIZE = 5

_MASK32 = 0xFFFFFFFF

GAMMA_MAX_PREFIX_CTX = 3
GAMMA_MAX_TAIL_CTX = 4


def _floor_log2(n: int) -> int:
    return n.bit_length() - 1


class BitModel:
    """Adaptive binary model (arith_bit_model)."""

    __slots__ = ("bit0_prob", "bit0_count", "bit_count",
                 "update_interval", "bits_until_update")

    def __init__(self):
        self.reset()

    def reset(self):
        self.bit0_count = 1
        self.bit_count = 2
        self.bit0_prob = 1 << (BM_LEN_SHIFT - 1)
        self.update_interval = 4
        self.bits_until_update = 4

    def update(self):
        if self.bit_count >= BM_MAX_COUNT:
            self.bit_count = (self.bit_count + 1) >> 1
            self.bit0_count = (self.bit0_count + 1) >> 1
            if self.bit0_count == self.bit_count:
                self.bit_count += 1
        scale = 0x80000000 // self.bit_count
        self.bit0_prob = (self.bit0_count * scale) >> (31 - BM_LEN_SHIFT)
        self.update_interval = min(max((5 * self.update_interval) >> 2, 4), 128)
        self.bits_until_update = self.update_interval


class DataModel:
    """Adaptive multi-symbol model (arith_data_model)."""

    __slots__ = ("num_syms", "sym_freqs", "total_sym_freq", "cum_sym_freqs",
                 "update_interval", "syms_until_update")

    def __init__(self, num_syms: int, faster_update: bool = False):
        assert 2 <= num_syms <= ARITH_MAX_SYMS
        self.num_syms = num_syms
        self.reset(faster_update)

    def reset(self, faster_update: bool = False):
        n = self.num_syms
        self.sym_freqs = [1] * n
        self.total_sym_freq = n
        self.cum_sym_freqs = [0] * (n + 1)
        self.update_interval = n
        self.syms_until_update = 0
        self.update()
        if faster_update:
            self.update_interval = min(max((n + 7) // 8, 4), (n + 6) << 3)
            self.syms_until_update = self.update_interval

    def update(self):
        n = self.num_syms
        while self.total_sym_freq >= DM_MAX_COUNT:
            self.total_sym_freq = 0
            for i in range(n):
                self.sym_freqs[i] = (self.sym_freqs[i] + 1) >> 1
                self.total_sym_freq += self.sym_freqs[i]
        scale = 0x80000000 // self.total_sym_freq
        s = 0
        cum = self.cum_sym_freqs
        for i in range(n):
            cum[i] = (scale * s) >> (31 - DM_LEN_SHIFT)
            s += self.sym_freqs[i]
        cum[n] = DM_MAX_COUNT
        self.update_interval = min(max((5 * self.update_interval) >> 2, 4),
                                   (n + 6) << 3)
        self.syms_until_update = self.update_interval


class GammaContexts:
    """Adaptive contexts for the gamma value code (arith_gamma_contexts)."""

    def __init__(self):
        self.prefix = [BitModel() for _ in range(GAMMA_MAX_PREFIX_CTX)]
        self.tail = [BitModel() for _ in range(GAMMA_MAX_TAIL_CTX)]


class ArithEncoder:
    """Range encoder (arith_enc)."""

    def __init__(self):
        self.buf = bytearray()
        self.base = 0
        self.length = ARITH_MAX_LEN

    def _prop_carry(self):
        b = self.buf
        ofs = len(b) - 1
        while ofs >= 0 and b[ofs] == 0xFF:
            b[ofs] = 0
            ofs -= 1
        if ofs >= 0:
            b[ofs] += 1

    def _renorm(self):
        while self.length < ARITH_MIN_LEN:
            self.buf.append((self.base >> 24) & 0xFF)
            self.base = (self.base << 8) & _MASK32
            self.length = (self.length << 8) & _MASK32

    def put_bit(self, bit: int):
        self.length >>= 1
        if bit:
            orig = self.base
            self.base = (self.base + self.length) & _MASK32
            if orig > self.base:
                self._prop_carry()
        if self.length < ARITH_MIN_LEN:
            self._renorm()

    def put_bits(self, val: int, num_bits: int):
        assert 0 < num_bits <= 20 and val < (1 << num_bits)
        self.length >>= num_bits
        orig = self.base
        self.base = (self.base + val * self.length) & _MASK32
        if orig > self.base:
            self._prop_carry()
        if self.length < ARITH_MIN_LEN:
            self._renorm()

    def put_truncated_binary(self, v: int, n: int):
        assert n >= 2 and v < n
        k = _floor_log2(n)          # n >= 2 so k >= 1
        u = (1 << (k + 1)) - n
        if v < u:
            self.put_bits(v, k)
            return
        x = v + u
        self.put_bits(x >> 1, k)
        self.put_bits(x & 1, 1)

    def put_rice(self, v: int, m: int):
        assert m
        q = v >> m
        for _ in range(q):
            self.put_bit(1)
        self.put_bit(0)
        self.put_bits(v & ((1 << m) - 1), m)

    def put_gamma(self, n: int, ctxs: GammaContexts):
        assert n > 0
        k = _floor_log2(n)
        assert k <= 16
        for i in range(k):
            self.encode_bit(1, ctxs.prefix[min(i, GAMMA_MAX_PREFIX_CTX - 1)])
        self.encode_bit(0, ctxs.prefix[min(k, GAMMA_MAX_PREFIX_CTX - 1)])
        for i in range(k - 1, -1, -1):
            self.encode_bit((n >> i) & 1,
                            ctxs.tail[min(i, GAMMA_MAX_TAIL_CTX - 1)])

    def encode_bit(self, bit: int, dm: BitModel):
        x = dm.bit0_prob * (self.length >> BM_LEN_SHIFT)
        if not bit:
            self.length = x
            dm.bit0_count += 1
        else:
            orig = self.base
            self.base = (self.base + x) & _MASK32
            self.length -= x
            if orig > self.base:
                self._prop_carry()
        dm.bit_count += 1
        if self.length < ARITH_MIN_LEN:
            self._renorm()
        dm.bits_until_update -= 1
        if dm.bits_until_update <= 0:
            dm.update()

    def encode_sym(self, sym: int, dm: DataModel):
        assert sym < dm.num_syms
        orig = self.base
        if sym == dm.num_syms - 1:
            x = dm.cum_sym_freqs[sym] * (self.length >> DM_LEN_SHIFT)
            self.base = (self.base + x) & _MASK32
            self.length -= x
        else:
            self.length >>= DM_LEN_SHIFT
            x = dm.cum_sym_freqs[sym] * self.length
            self.base = (self.base + x) & _MASK32
            self.length = dm.cum_sym_freqs[sym + 1] * self.length - x
        if orig > self.base:
            self._prop_carry()
        if self.length < ARITH_MIN_LEN:
            self._renorm()
        dm.sym_freqs[sym] += 1
        dm.total_sym_freq += 1
        dm.syms_until_update -= 1
        if dm.syms_until_update <= 0:
            dm.update()

    def flush(self) -> bytes:
        orig = self.base
        if self.length <= 2 * ARITH_MIN_LEN:
            self.base = (self.base + (ARITH_MIN_LEN >> 1)) & _MASK32
            self.length = ARITH_MIN_LEN >> 9
        else:
            self.base = (self.base + ARITH_MIN_LEN) & _MASK32
            self.length = ARITH_MIN_LEN >> 1
        if orig > self.base:
            self._prop_carry()
        self._renorm()
        while len(self.buf) < MIN_BUF_SIZE:
            self.buf.append(0)
        return bytes(self.buf)


class ArithDecoder:
    """Range decoder (arith_dec)."""

    def __init__(self, data: bytes):
        if len(data) < MIN_BUF_SIZE:
            raise ValueError("arith stream too short")
        self.data = data
        self.pos = 4
        self.value = (data[0] << 24) | (data[1] << 16) | (data[2] << 8) | data[3]
        self.length = ARITH_MAX_LEN

    def _renorm(self):
        while True:
            nb = self.data[self.pos] if self.pos < len(self.data) else 0
            self.pos += 1
            self.value = ((self.value << 8) | nb) & _MASK32
            self.length = (self.length << 8) & _MASK32
            if self.length >= ARITH_MIN_LEN:
                break

    def get_bit(self) -> int:
        self.length >>= 1
        bit = 1 if self.value >= self.length else 0
        if bit:
            self.value -= self.length
        if self.length < ARITH_MIN_LEN:
            self._renorm()
        return bit

    def get_bits(self, num_bits: int) -> int:
        assert 0 < num_bits <= 20
        self.length >>= num_bits
        v = self.value // self.length
        self.value -= self.length * v
        if self.length < ARITH_MIN_LEN:
            self._renorm()
        return v

    def decode_truncated_binary(self, n: int) -> int:
        assert n >= 2
        k = _floor_log2(n)
        u = (1 << (k + 1)) - n
        result = self.get_bits(k) if k else 0
        if result >= u:
            result = ((result << 1) | self.get_bits(1)) - u
        return result

    def decode_rice(self, m: int) -> int:
        q = 0
        while self.get_bit():
            q += 1
            if q > 64:
                raise ValueError("corrupt rice code")
        return (q << m) + self.get_bits(m)

    def decode_bit(self, dm: BitModel) -> int:
        x = dm.bit0_prob * (self.length >> BM_LEN_SHIFT)
        bit = 1 if self.value >= x else 0
        if bit == 0:
            self.length = x
            dm.bit0_count += 1
        else:
            self.value -= x
            self.length -= x
        dm.bit_count += 1
        if self.length < ARITH_MIN_LEN:
            self._renorm()
        dm.bits_until_update -= 1
        if dm.bits_until_update <= 0:
            dm.update()
        return bit

    def decode_gamma(self, ctxs: GammaContexts) -> int:
        k = 0
        while self.decode_bit(ctxs.prefix[min(k, GAMMA_MAX_PREFIX_CTX - 1)]):
            k += 1
            if k > 16:
                raise ValueError("corrupt gamma code")
        n = 1 << k
        for i in range(k - 1, -1, -1):
            n |= self.decode_bit(ctxs.tail[min(i, GAMMA_MAX_TAIL_CTX - 1)]) << i
        return n

    def decode_sym(self, dm: DataModel) -> int:
        cum = dm.cum_sym_freqs
        x, y = 0, self.length       # y keeps the PRE-shift length (ref :3156)
        self.length >>= DM_LEN_SHIFT
        lo, hi = 0, dm.num_syms
        mid = hi >> 1
        while mid != lo:
            z = self.length * cum[mid]
            if z > self.value:
                hi, y = mid, z
            else:
                lo, x = mid, z
            mid = (lo + hi) >> 1
        self.value -= x
        self.length = y - x
        if self.length < ARITH_MIN_LEN:
            self._renorm()
        dm.sym_freqs[lo] += 1
        dm.total_sym_freq += 1
        dm.syms_until_update -= 1
        if dm.syms_until_update <= 0:
            dm.update()
        return lo
