"""The plain fused multiply-add of `basis_universal_tpu_torch/ops/xla_order.py`
(`fma_reference`, which every CPU-tensor route of the port runs, and the
chains of `_cross6`'s plain version) rounds once, as XLA-CPU's `vfmadd` and
the card's `__fmaf_rn` do.

The oracle is exact: `fractions.Fraction` holds a * b + c, and the result
must be the nearest float32 to it, ties to the even significand, found by
comparing the two float32 neighbours of a candidate exactly. Inputs are made
from a seed with numpy: random triples, triples that nearly cancel, and
triples built to land just off, or on, a float32 midpoint, where a sum
rounded to float64 first and to float32 after can land on the midpoint and
round the wrong way. Tolerance: none, every value equal.
"""

from fractions import Fraction

import numpy as np
import pytest
import torch

from basis_universal_tpu_torch.ops import xla_order as xo


def _nearest_f32(x: Fraction) -> np.float32:
    """The float32 nearest to the exact x, ties to even."""
    cand = np.float32(float(x))              # within an ulp of the answer
    best = None
    for v in (np.nextafter(cand, np.float32(-np.inf)), cand,
              np.nextafter(cand, np.float32(np.inf))):
        if not np.isfinite(v):
            continue
        d = abs(Fraction(float(v)) - x)
        even = int(np.array(v).view(np.uint32)) % 2 == 0
        if best is None or d < best[0] or (d == best[0] and even):
            best = (d, v)
    return best[1]


def _oracle(a, b, c):
    return np.array([_nearest_f32(Fraction(float(x)) * Fraction(float(y))
                                  + Fraction(float(z)))
                     for x, y, z in zip(a, b, c)], dtype=np.float32)


def _near_midpoints(rng, n):
    """(a, b, c) float32 with a * b within about 2^-46 of half an ulp of c
    (above or below it), or exactly half an ulp: c + a * b rounds to one of
    c's neighbours by a margin smaller than float64 keeps."""
    e = rng.integers(-20, 20, n)
    c = np.ldexp(1.0 + rng.integers(0, 2 ** 23, n) * 2.0 ** -23, e)
    half = np.ldexp(1.0, e - 24)
    m = rng.integers(1, 64, n)
    sign = rng.choice([-1.0, 1.0], n)
    a = 1.0 + sign * m * 2.0 ** -23
    b = (1.0 - sign * m * 2.0 ** -23) * half       # a * b = half (1 - m^2 2^-46)
    exact = rng.random(n) < 0.25
    a = np.where(exact, 1.0, a)
    b = np.where(exact, half, b)
    neg = rng.random(n) < 0.5
    c = np.where(neg, -c, c)
    b = np.where(rng.random(n) < 0.5, -b, b)
    return (a.astype(np.float32), b.astype(np.float32), c.astype(np.float32))


def test_witness_rounds_once():
    """One rounding of 1 + 2^-23 + 2^-24 (1 - 2^-46) is 1 + 2^-23; through
    a float64 sum rounded again it was 1 + 2^-22."""
    a = torch.tensor([1 + 2 ** -23], dtype=torch.float32)
    b = torch.tensor([(1 - 2 ** -23) * 2 ** -24], dtype=torch.float32)
    got = xo.fma_reference(a, b, a)
    assert got.dtype == torch.float32
    assert got.item() == 1 + 2 ** -23
    assert xo._fma(a, b, a).item() == 1 + 2 ** -23


@pytest.mark.parametrize("kind", ["random", "cancelling", "near_midpoint",
                                  "scalars"])
def test_fma_reference_is_the_exact_sum_rounded_once(kind):
    rng = np.random.default_rng(["random", "cancelling", "near_midpoint",
                                 "scalars"].index(kind) + 100)
    n = 3000
    if kind == "near_midpoint":
        a, b, c = _near_midpoints(rng, n)
    else:
        a = (rng.normal(0, 1, n) * np.exp2(rng.integers(-30, 30, n))
             ).astype(np.float32)
        b = (rng.normal(0, 1, n) * np.exp2(rng.integers(-30, 30, n))
             ).astype(np.float32)
        if kind == "cancelling":
            c = (-(a.astype(np.float64) * b) * (1 + rng.normal(0, 1e-6, n))
                 ).astype(np.float32)
        else:
            c = (rng.normal(0, 1, n) * np.exp2(rng.integers(-30, 30, n))
                 ).astype(np.float32)
    if kind == "scalars":
        # a Python float that is a float32 value, as the port passes 257.0
        b[:] = np.float32(257.0)
        got = xo.fma_reference(torch.from_numpy(a), 257.0, torch.from_numpy(c))
    else:
        got = xo.fma_reference(*(torch.from_numpy(x) for x in (a, b, c)))
    want = _oracle(a, b, c)
    assert got.dtype == torch.float32
    differ = got.numpy().view(np.uint32) != want.view(np.uint32)
    assert not differ.any(), (a[differ][:4], b[differ][:4], c[differ][:4])


def test_near_midpoints_hit_the_double_rounding():
    """The near-midpoint triples are cases where rounding twice goes wrong
    (so the test above holds the repair, not luck)."""
    a, b, c = _near_midpoints(np.random.default_rng(102), 3000)
    twice = (a.astype(np.float64) * b + c).astype(np.float32)
    assert (twice.view(np.uint32) != _oracle(a, b, c).view(np.uint32)).sum() \
        > 100


def _cross6_oracle(a, b):
    """`_cross6`'s order, each step rounded once by the exact oracle: the
    first product (two where C mod 64 is 1..32) rounded, fused
    multiply-adds into it (the even and the odd terms), the two chains'
    float32 add."""
    lanes = 2 if 1 <= b.shape[0] % 64 <= 32 else 1
    out = np.empty((a.shape[0], b.shape[0]), np.float32)
    for i in range(a.shape[0]):
        for j in range(b.shape[0]):
            acc = [_nearest_f32(Fraction(float(a[i, k])) * Fraction(float(b[j, k])))
                   for k in range(lanes)]
            for k in range(lanes, 6):
                acc[k % lanes] = _nearest_f32(
                    Fraction(float(a[i, k])) * Fraction(float(b[j, k]))
                    + Fraction(float(acc[k % lanes])))
            out[i, j] = acc[0] if lanes == 1 else _nearest_f32(
                Fraction(float(acc[0])) + Fraction(float(acc[1])))
    return out


@pytest.mark.parametrize("c_n", [33, 40])
def test_cross6_plain_chain_rounds_once(c_n):
    """C 33 sums in one chain, C 40 in two; row 0 against column 0 is the
    witness inside the chain, the rest random."""
    rng = np.random.default_rng(c_n)
    a = rng.normal(0, 1, (24, 6)).astype(np.float32)
    b = rng.normal(0, 1, (c_n, 6)).astype(np.float32)
    a[0] = b[0] = 0.0
    lanes = 2 if 1 <= c_n % 64 <= 32 else 1
    a[0, 0], b[0, 0] = 1 + 2 ** -23, 1.0
    a[0, lanes], b[0, lanes] = 1 + 2 ** -23, (1 - 2 ** -23) * 2 ** -24
    got = xo._cross6(torch.from_numpy(a), torch.from_numpy(b)).numpy()
    want = _cross6_oracle(a, b)
    assert got[0, 0] == np.float32(1 + 2 ** -23)
    np.testing.assert_array_equal(got.view(np.uint32), want.view(np.uint32))
