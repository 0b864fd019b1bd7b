"""The reference's random draws, reproduced with numpy.

The JAX package fills empty k-means seeds with `jax.random.choice(
jax.random.PRNGKey(seed), vecs, (k,))`: indices drawn uniformly with
replacement by JAX's default generator, Threefry-2x32 (20 rounds) with the
partitionable key split and bit layout (`jax_threefry_partitionable`, on by
default since JAX 0.5). `choice_indices` computes the same indices on the
host, so the port's codebooks match the reference's without JAX.
"""

import numpy as np

_ROT = ((13, 15, 26, 6), (17, 29, 16, 24))


def _rotl(x, r: int):
    return (x << np.uint32(r)) | (x >> np.uint32(32 - r))


def threefry2x32(k1, k2, x1, x2):
    """Threefry-2x32 of the counter words (x1, x2) under the key (k1, k2);
    uint32 arrays in (keys and counters broadcast), uint32 arrays out."""
    k1, k2 = np.asarray(k1, np.uint32), np.asarray(k2, np.uint32)
    ks = (k1, k2, k1 ^ k2 ^ np.uint32(0x1BD11BDA))
    x = [np.asarray(x1, np.uint32) + ks[0], np.asarray(x2, np.uint32) + ks[1]]
    for i in range(5):
        for r in _ROT[i % 2]:
            x[0] = x[0] + x[1]
            x[1] = x[0] ^ _rotl(x[1], r)
        x[0] = x[0] + ks[(i + 1) % 3]
        x[1] = x[1] + ks[(i + 2) % 3] + np.uint32(i + 1)
    return x[0], x[1]


def _split(key):
    """The two subkeys of jax.random.split(key) (fold-like split); keys of
    shape (S, 1) give subkeys of shape (S, 1)."""
    b1, b2 = threefry2x32(key[0], key[1], np.zeros(2, np.uint32),
                          np.arange(2, dtype=np.uint32))
    return (b1[..., :1], b2[..., :1]), (b1[..., 1:], b2[..., 1:])


def _bits32(key, n: int):
    """n random uint32 words, as jax.random.bits(key, (n,)) gives them,
    (S, n) for keys of shape (S, 1)."""
    b1, b2 = threefry2x32(key[0], key[1], np.zeros(n, np.uint32),
                          np.arange(n, dtype=np.uint32))
    return b1 ^ b2


def choice_indices(seed: int, n: int, k: int) -> np.ndarray:
    """The k indices into n items that jax.random.choice(PRNGKey(seed),
    n items, (k,)) picks (with replacement), as int64."""
    return choice_indices_many([seed], n, k)[0]


def choice_indices_many(seeds, n: int, k: int) -> np.ndarray:
    """`choice_indices` of each seed, (len(seeds), k) int64, drawn in one
    pass over all the seeds' counters."""
    with np.errstate(over="ignore"):
        # PRNGKey of a 32-bit seed: (0, seed)
        lows = np.array([int(s) & 0xFFFFFFFF for s in seeds],
                        dtype=np.uint32)[:, None]
        k1, k2 = _split((np.zeros_like(lows), lows))
        hi, lo = _bits32(k1, k), _bits32(k2, k)
        span = np.uint32(max(n, 1))
        mult = np.uint32((1 << 16) % int(span))
        mult = np.uint32(((int(mult) * int(mult)) & 0xFFFFFFFF) % int(span))
        off = (hi % span) * mult + lo % span
        return (off % span).astype(np.int64)
