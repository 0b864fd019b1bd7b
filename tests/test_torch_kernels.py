"""The port's kernel wrappers (`basis_universal_tpu_torch/ops/cuda_etc1s.py`)
against the reference's Pallas kernels in interpret mode and against the
reference's XLA formulations, on the CPU, where each wrapper runs its plain
PyTorch version.

Tolerances:
- floats: rtol 1e-5. The factorized scan's error formula adds terms far
  larger than the error and cancels them, so two float32 evaluations in
  different orders differ by ulps of those terms: its bound is
  1e-5 * |want| + 1e-6 * M, M = `checks.scan_term_magnitude` (1e-6 is about
  8 float32 ulps; measured here: up to 1.8e-7 * M).
- indices: equal except where the two choices' errors tie within the float
  tolerance; the tie rate is printed.

The kernels themselves run only on a CUDA card: `test_torch_cuda.py` holds
them against these plain versions there.
"""

import pathlib
import re

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from basis_universal_tpu.ops import etc1s_encode as jops
from basis_universal_tpu.ops import pallas_etc1s
from basis_universal_tpu.ops.etc1 import ETC1_INTEN_TABLES
from basis_universal_tpu_torch.ops import cuda_etc1s as ck
from basis_universal_tpu_torch.ops import etc1s_encode as tops
from basis_universal_tpu_torch.testing.checks import scan_term_magnitude

RTOL = 1e-5
SCAN_MAG_TOL = 1e-6
B = 300          # not a multiple of any kernel tile (2048, 1024, 512)


def _blocks(n, seed):
    """Texture-like 4x4 blocks: a base colour with small variation, some
    saturated (gamut-clip cases) and some unstructured."""
    rng = np.random.default_rng(seed)
    base = rng.integers(0, 256, (n, 1, 3))
    px = base + rng.integers(-24, 25, (n, 16, 3))
    px[: n // 6] = rng.integers(0, 256, (n // 6, 16, 3))
    px[n // 6: n // 4] = np.where(rng.integers(0, 2, (n // 4 - n // 6, 16, 3)),
                                  rng.integers(0, 12, (1,)), 255 - rng.integers(0, 12, (1,)))
    return np.clip(px, 0, 255).astype(np.float32)


def _packed(n, k, seed):
    rng = np.random.default_rng(seed)
    c5 = rng.integers(0, 32, (n, k, 3))
    tt = rng.integers(0, 8, (n, k))
    return (c5[..., 0] | (c5[..., 1] << 5) | (c5[..., 2] << 10)
            | (tt << 15)).astype(np.int32)


def _metric_scale(px, perceptual):
    x = px @ jops.PERC_P.T if perceptual else px
    return (x * x).sum((1, 2))[:, None]


def _assert_close(got, want, scale=0.0, rtol=RTOL):
    got = np.asarray(got, np.float64)
    want = np.asarray(want, np.float64)
    bound = rtol * (np.abs(want) + scale)
    bad = np.abs(got - want) > bound
    assert not bad.any(), (f"{bad.sum()} of {bad.size} outside tolerance; "
                           f"max abs err {np.abs(got - want).max()}")


def _assert_scan_close(got, want, px, base5, radius, perceptual):
    mag = scan_term_magnitude(torch.from_numpy(px),
                              None if base5 is None else torch.from_numpy(base5),
                              radius, perceptual).numpy().astype(np.float64)
    got = np.asarray(got, np.float64)
    want = np.asarray(want, np.float64)
    bound = RTOL * np.abs(want) + SCAN_MAG_TOL * mag
    bad = np.abs(got - want) > bound
    assert not bad.any(), (f"{bad.sum()} of {bad.size} outside tolerance; "
                           f"max abs err {np.abs(got - want).max()}")


def _xla_scan(px, base5, radius, perceptual):
    """The reference's XLA candidate scan (`_scan_block_errs`), (B, D*8)."""
    deltas = jnp.asarray(jops._candidate_deltas(radius))
    if base5 is None:
        base5 = jnp.clip(jnp.round(jnp.mean(px, axis=1) * (31.0 / 255.0)),
                         0, 31).astype(jnp.int32)
    c5s = jnp.clip(jnp.asarray(base5, jnp.int32)[None] + deltas[:, None, :],
                   0, 31)
    gvec = jnp.asarray(jops.PERC_P @ np.ones(3, np.float32)) if perceptual else None
    px_m = jops.perceptual_transform(px) if perceptual else px
    base8 = jops.expand5(c5s).astype(jnp.float32)
    if perceptual:
        base8 = jops.perceptual_transform(base8)
    err = jops._scan_block_errs(jops._block_moments(px_m, gvec), base8,
                                gvec=gvec)
    return np.asarray(jnp.moveaxis(err, 1, 0).reshape(px.shape[0], -1))


@pytest.mark.parametrize("perceptual", [False, True])
@pytest.mark.parametrize("external", [False, True])
@pytest.mark.parametrize("radius", [1, 2])
def test_factorized_scan_matches_pallas_and_xla(radius, external, perceptual):
    px = _blocks(B, 11 + radius)
    rng = np.random.default_rng(5)
    base5 = rng.integers(0, 32, (B, 3)).astype(np.float32) if external else None
    got = ck.factorized_scan(
        torch.from_numpy(px),
        None if base5 is None else torch.from_numpy(base5),
        radius=radius, perceptual=perceptual)
    assert got.shape == (B, (2 * radius + 1) ** 3 * 8)
    pallas = pallas_etc1s.factorized_scan(
        jnp.asarray(px), None if base5 is None else jnp.asarray(base5),
        radius=radius, interpret=True, perceptual=perceptual)
    _assert_scan_close(got.numpy(), np.asarray(pallas), px, base5, radius,
                       perceptual)
    _assert_scan_close(got.numpy(), _xla_scan(jnp.asarray(px), base5, radius,
                                              perceptual),
                       px, base5, radius, perceptual)


@pytest.mark.parametrize("perceptual", [False, True])
@pytest.mark.parametrize("k", [16, 5])
def test_palette_errs_packed_matches_pallas_and_xla(k, perceptual):
    px = _blocks(B, 21)
    packed = _packed(B, k, 22)
    got = ck.palette_errs_packed(torch.from_numpy(px), torch.from_numpy(packed),
                                 perceptual=perceptual).numpy()
    want = np.asarray(pallas_etc1s.palette_errs_packed(
        jnp.asarray(px), jnp.asarray(packed), interpret=True,
        perceptual=perceptual))
    if perceptual:
        _assert_close(got, want)
    else:
        # integer pixels and palettes: every partial sum is exact
        np.testing.assert_array_equal(got, want)
    # the XLA formulation: explicit palettes, both operands transformed
    c5 = np.stack([packed & 31, (packed >> 5) & 31, (packed >> 10) & 31], -1)
    b8 = (c5 << 3) | (c5 >> 2)
    pal = np.clip(b8[:, :, None, :] + ETC1_INTEN_TABLES[(packed >> 15) & 7]
                  [..., None], 0, 255).astype(np.float32)
    x, p = jnp.asarray(px), jnp.asarray(pal)
    if perceptual:
        x, p = jops.perceptual_transform(x), jops.perceptual_transform(p)
    xla = np.asarray(jops._palette_errs(x, p))
    # transforming both operands (not their difference) cancels: bound the
    # error by the transformed magnitudes
    scale = _metric_scale(px, perceptual) if perceptual else 0.0
    _assert_close(got, xla, scale)


def _explicit_palettes(packed):
    """(B, K, 4, 3) float32 clipped palettes of packed candidates."""
    c5 = np.stack([packed & 31, (packed >> 5) & 31, (packed >> 10) & 31], -1)
    b8 = (c5 << 3) | (c5 >> 2)
    return np.clip(b8[:, :, None, :] + ETC1_INTEN_TABLES[(packed >> 15) & 7]
                   [..., None], 0, 255).astype(np.float32)


@pytest.mark.parametrize("perceptual", [False, True])
@pytest.mark.parametrize("k", [16, 3])
def test_palette_errs_matches_pallas_and_xla(k, perceptual):
    """B = 300 is not a multiple of the Pallas kernel's 2048-block tile."""
    px = _blocks(B, 51)
    pal = _explicit_palettes(_packed(B, k, 52))
    if perceptual:
        # the callers' perceptual scoring: both operands transformed
        px = np.array(jops.perceptual_transform(jnp.asarray(px)))
        pal = np.array(jops.perceptual_transform(jnp.asarray(pal)))
    got = ck.palette_errs(torch.from_numpy(px), torch.from_numpy(pal)).numpy()
    assert got.shape == (B, k) and got.dtype == np.float32
    pallas = np.asarray(pallas_etc1s.palette_errs(
        jnp.asarray(px), jnp.asarray(pal), interpret=True))
    xla = np.asarray(jops._palette_errs(jnp.asarray(px), jnp.asarray(pal)))
    if perceptual:
        _assert_close(got, pallas)
        _assert_close(got, xla)
    else:
        # integer pixels and palettes: every partial sum is exact
        np.testing.assert_array_equal(got, pallas)
        np.testing.assert_array_equal(got, xla)


@pytest.mark.parametrize("rows", [(4000,), (4000, 6), (4000, 16, 4)])
def test_segment_sum_matches_index_add_and_jax(rows):
    rng = np.random.default_rng(len(rows))
    data = (rng.standard_normal(rows) * 1000.0).astype(np.float32)
    ids = rng.integers(0, 250, rows[0])
    ids[ids == 17] = 18                         # an empty segment
    got = tops.segment_sum(torch.from_numpy(data), torch.from_numpy(ids), 260)
    want = torch.zeros((260,) + rows[1:]).index_add_(
        0, torch.from_numpy(ids), torch.from_numpy(data))
    assert torch.equal(got, want)
    assert not got[17].any()
    seg = np.asarray(jax.ops.segment_sum(jnp.asarray(data), jnp.asarray(ids),
                                         num_segments=260))
    scale = np.abs(data).max() * 20.0           # ~the largest partial sums
    _assert_close(got.numpy(), seg, scale)
    # integer data keeps an (exact) index_add_
    counts = tops.segment_sum(torch.ones(rows[0], dtype=torch.int64),
                              torch.from_numpy(ids), 260)
    np.testing.assert_array_equal(counts.numpy(),
                                  np.bincount(ids, minlength=260))


def _selector_check(best, val, want_best, want_val, dists, patterns):
    """Min errors close; indices equal except at ties. Returns tie count."""
    _assert_close(val, want_val)
    d = np.asarray(jnp.asarray(dists).astype(jnp.bfloat16).astype(jnp.float32))
    err_of = d[np.arange(d.shape[0])[:, None], np.arange(16)[None, :],
               patterns[best]].sum(-1)
    differ = best != want_best
    assert np.all(np.abs(err_of[differ] - want_val[differ])
                  <= RTOL * np.abs(want_val[differ])), "index differs off a tie"
    return int(differ.sum())


@pytest.mark.parametrize("s", [700, 37])
def test_find_best_selector_patterns_matches_pallas_and_xla(s):
    rng = np.random.default_rng(31)
    px = _blocks(B, 32)
    pal = np.clip(rng.integers(0, 256, (B, 1, 3))
                  + np.array([-40, -12, 12, 40])[None, :, None], 0, 255)
    dists = ((px[:, :, None, :] - pal[:, None, :, :].astype(np.float32)) ** 2
             ).sum(-1).astype(np.float32)
    patterns = rng.integers(0, 4, (s, 16)).astype(np.int32)
    patterns[s // 2] = patterns[s // 3]          # a duplicate: an exact tie
    best, val = ck.find_best_selector_patterns(
        torch.from_numpy(dists), torch.from_numpy(patterns), s)
    best, val = best.numpy(), val.numpy()
    assert best.dtype == np.int32 and val.dtype == np.float32
    pb, pv = pallas_etc1s.find_best_selector_patterns(
        jnp.asarray(dists), jnp.asarray(patterns), s, interpret=True)
    xb, xv = jops.find_best_selector_patterns(jnp.asarray(dists),
                                              jnp.asarray(patterns), s)
    ties = _selector_check(best, val, np.asarray(pb), np.asarray(pv), dists,
                           patterns)
    ties += _selector_check(best, val, np.asarray(xb), np.asarray(xv), dists,
                            patterns)
    print(f"selector search S={s}: {ties} index ties of {2 * B}")
    # the duplicated pattern never wins over its earlier twin
    assert not np.any(best == s // 2)


def test_pack_patterns_layout():
    rng = np.random.default_rng(3)
    pats = rng.integers(0, 4, (50, 16)).astype(np.int32)
    words = ck.pack_patterns(torch.from_numpy(pats)).numpy()
    assert words.dtype == np.int32
    u = words.astype(np.int64) & 0xFFFFFFFF
    back = (u[:, None] >> (np.arange(16) * 2)) & 3
    np.testing.assert_array_equal(back, pats)


def _cu_array(src, name):
    body = re.search(name + r"\[[^\]]*\](?:\[[^\]]*\])?\s*=\s*\{(.*?)\};", src,
                     re.S).group(1)
    return np.array([float(v.rstrip("f")) for v in
                     re.findall(r"-?\d+(?:\.\d+)?f?", body)])


def test_cuda_source_constants_match_python():
    """The tables baked into the CUDA source are the reference's."""
    src = (pathlib.Path(ck.__file__).resolve().parent.parent / "csrc"
           / "etc1s_kernels.cu").read_text()
    np.testing.assert_array_equal(_cu_array(src, "kTabs").reshape(8, 4),
                                  ETC1_INTEN_TABLES)
    np.testing.assert_array_equal(_cu_array(src, "kMids").reshape(8, 3),
                                  ck._INTEN_MID)
    for r, name in ((1, "kDeltasR1"), (2, "kDeltasR2")):
        np.testing.assert_array_equal(_cu_array(src, name).reshape(-1, 3),
                                      tops._candidate_deltas(r))
    defs = dict(re.findall(r"#define (\w+) (-?[\d.]+)f", src))
    for i in range(3):
        for j in range(3):
            assert np.float32(defs[f"P{i}{j}"]) == tops.PERC_P[i, j]
    assert np.float32(defs["SQRT3"]) == np.float32(np.sqrt(3.0))
    assert np.float32(defs["THIRD"]) == np.float32(1.0 / 3.0)
    assert np.float32(defs["C31_255"]) == np.float32(31.0 / 255.0)


def test_wrappers_reject_bad_inputs():
    px = torch.zeros((8, 16, 3))
    with pytest.raises(TypeError):
        ck.factorized_scan(px.double())
    with pytest.raises(ValueError):
        ck.factorized_scan(torch.zeros((8, 16, 4)))
    with pytest.raises(ValueError):
        ck.factorized_scan(torch.zeros((16, 8, 3)).transpose(0, 1))
    with pytest.raises(ValueError):
        ck.factorized_scan(px, radius=3)
    with pytest.raises(ValueError):
        ck.factorized_scan(px, base5=torch.zeros((7, 3)))
    with pytest.raises(TypeError):
        ck.palette_errs_packed(px, torch.zeros((8, 4), dtype=torch.int64))
    with pytest.raises(ValueError):
        ck.palette_errs_packed(px, torch.zeros((7, 4), dtype=torch.int32))
    with pytest.raises(ValueError):
        ck.palette_errs(px, torch.zeros((8, 4, 3, 3)))
    with pytest.raises(TypeError):
        ck.palette_errs(px, torch.zeros((8, 4, 4, 3), dtype=torch.float64))
    with pytest.raises(ValueError):
        ck.find_best_selector_patterns(torch.zeros((8, 16, 4)),
                                       torch.zeros((5, 16), dtype=torch.int32),
                                       6)


def test_cpu_tensors_run_the_plain_version_without_launching():
    ck.reset_launch_counts()
    px = torch.from_numpy(_blocks(40, 9))
    np.testing.assert_array_equal(
        ck.factorized_scan(px).numpy(),
        ck.factorized_scan_reference(px).numpy())
    packed = torch.from_numpy(_packed(40, 4, 1))
    np.testing.assert_array_equal(
        ck.palette_errs_packed(px, packed).numpy(),
        ck.palette_errs_packed_reference(px, packed).numpy())
    pal = torch.from_numpy(_explicit_palettes(_packed(40, 4, 2)))
    np.testing.assert_array_equal(
        ck.palette_errs(px, pal).numpy(),
        ck.palette_errs_reference(px, pal).numpy())
    assert all(v == 0 for v in ck.LAUNCHES.values())
