"""Copy of `basis_universal_tpu/entropy/bitio.py`.

LSB-first bitstream I/O matching the .basis bit order.

The reference bitstream fills each byte from its least-significant bit
(bitwise_decoder::get_bits, transcoder/basisu_transcoder_internal.h:460-540;
encoder side bitwise_coder in encoder/basisu_enc.h). Values are written
low-bit-first, i.e. bit k of the stream lives at byte[k>>3] bit (k&7).

The writer is numpy-vectorized: callers append whole arrays of
(value, nbits) pairs; flush() computes bit offsets with a cumsum and
scatters 5 bytes per item with np.bitwise_or.at. No Python per-symbol loop.
"""

import numpy as np


class BitWriter:
    def __init__(self):
        self._vals = []   # list of uint64 arrays
        self._lens = []   # list of uint8 arrays (0..32)

    def put_bits(self, value: int, nbits: int):
        assert 0 <= nbits <= 32
        assert value < (1 << nbits) if nbits < 64 else True
        self._vals.append(np.asarray([value], dtype=np.uint64))
        self._lens.append(np.asarray([nbits], dtype=np.uint8))

    def put_bits_array(self, values, nbits):
        """Append arrays of values each with its own bit length."""
        values = np.asarray(values, dtype=np.uint64).ravel()
        nbits = np.asarray(nbits, dtype=np.uint8).ravel()
        if nbits.size == 1 and values.size > 1:
            nbits = np.full(values.shape, nbits[0], dtype=np.uint8)
        assert values.shape == nbits.shape
        self._vals.append(values)
        self._lens.append(nbits)

    def put_vlc(self, value: int, chunk_bits: int):
        """Variable-length code: chunks of `chunk_bits` with a continue bit.

        Inverse of bitwise_decoder::decode_vlc
        (transcoder/basisu_transcoder_internal.h:598-626).
        """
        assert chunk_bits >= 1
        v = int(value)
        mask = (1 << chunk_bits) - 1
        while True:
            chunk = v & mask
            v >>= chunk_bits
            if v:
                self.put_bits(chunk | (1 << chunk_bits), chunk_bits + 1)
            else:
                self.put_bits(chunk, chunk_bits + 1)
                break

    def put_vlc_array(self, values, chunk_bits: int):
        """Vectorized VLC write for an array of values."""
        values = np.asarray(values, dtype=np.uint64).ravel()
        if values.size == 0:
            return
        mask = np.uint64((1 << chunk_bits) - 1)
        cont = np.uint64(1 << chunk_bits)
        v = values.copy()
        # Interleave chunks item-by-item is required (each value's chunks are
        # contiguous); emit per-round with a stable compaction keyed on the
        # original order. Max 32/chunk_bits rounds.
        chunks = []   # (orig_index, chunk_value)
        order = np.arange(values.size)
        round_id = 0
        while v.size:
            c = v & mask
            v = v >> np.uint64(chunk_bits)
            more = v != 0
            out = np.where(more, c | cont, c)
            chunks.append((order.copy(), np.full(order.shape, round_id), out))
            order = order[more]
            v = v[more]
            round_id += 1
        idx = np.concatenate([c[0] for c in chunks])
        rnd = np.concatenate([c[1] for c in chunks])
        val = np.concatenate([c[2] for c in chunks])
        # sort by (orig index, round) so each value's chunks are in order
        perm = np.lexsort((rnd, idx))
        self.put_bits_array(val[perm], np.full(val.shape, chunk_bits + 1))

    def bit_length(self) -> int:
        return int(sum(int(l.astype(np.uint64).sum()) for l in self._lens))

    def to_bytes(self) -> bytes:
        if not self._vals:
            return b""
        vals = np.concatenate(self._vals)
        lens = np.concatenate(self._lens).astype(np.uint64)
        offs = np.zeros(lens.shape, dtype=np.uint64)
        np.cumsum(lens[:-1], out=offs[1:])
        total_bits = int(offs[-1] + lens[-1]) if lens.size else 0
        nbytes = (total_bits + 7) >> 3
        buf = np.zeros(nbytes + 8, dtype=np.uint8)
        byte_idx = (offs >> np.uint64(3)).astype(np.int64)
        shift = (offs & np.uint64(7)).astype(np.uint64)
        shifted = vals << shift  # up to 32+7=39 bits
        for j in range(5):
            b = ((shifted >> np.uint64(8 * j)) & np.uint64(0xFF)).astype(np.uint8)
            np.bitwise_or.at(buf, byte_idx + j, b)
        return buf[:nbytes].tobytes()


class BitReader:
    """Serial LSB-first bit reader (host-side decode path)."""

    def __init__(self, data: bytes):
        self._data = np.frombuffer(bytes(data), dtype=np.uint8)
        # pre-widen into a python int window lazily
        self._pos = 0          # bit position
        self._nbits = len(data) * 8

    def get_bits(self, n: int) -> int:
        assert n <= 32
        p = self._pos
        self._pos = p + n
        byte0 = p >> 3
        # gather up to 5 bytes
        window = int.from_bytes(self._data[byte0:byte0 + 5].tobytes().ljust(5, b"\0"), "little")
        return (window >> (p & 7)) & ((1 << n) - 1)

    def decode_vlc(self, chunk_bits: int) -> int:
        mask = (1 << chunk_bits) - 1
        v = 0
        ofs = 0
        while True:
            s = self.get_bits(chunk_bits + 1)
            v |= (s & mask) << ofs
            ofs += chunk_bits
            if not (s & (1 << chunk_bits)):
                break
            if ofs >= 32:
                raise ValueError("VLC too long")
        return v

    def bits_remaining(self) -> int:
        return self._nbits - self._pos
