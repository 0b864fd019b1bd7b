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


def _xla_scan(px, base5, radius, perceptual, minterm=False):
    """The reference's XLA candidate scan (`_scan_block_errs`), (B, D*8); with
    `minterm`, its gray-axis sums (`_gray_axis_minterm` of its u)."""
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
    mom = jops._block_moments(px_m, gvec)
    if minterm:
        lb = jnp.sum(base8, axis=-1) if gvec is None else base8 @ gvec
        u = (mom["luma"][None] - lb[..., None]) * (1.0 / 3.0)
        err = jops._gray_axis_minterm(u)
    else:
        err = jops._scan_block_errs(mom, base8, gvec=gvec)
    return jnp.moveaxis(err, 1, 0).reshape(px.shape[0], -1)


@pytest.mark.parametrize("perceptual", [False, True])
@pytest.mark.parametrize("external", [False, True])
@pytest.mark.parametrize("radius", [1, 2])
def test_factorized_scan_matches_pallas_and_xla(radius, external, perceptual):
    """The scan's gray-axis sums (what the wrapper returns) equal the
    reference's XLA sums, jitted, bit for bit with whole-numbered pixels and
    RGB; the errors assembled from the same terms (what the shortlist
    ranks) match the reference's Pallas scan and its XLA scan."""
    px = _blocks(B, 11 + radius)
    rng = np.random.default_rng(5)
    base5 = rng.integers(0, 32, (B, 3)).astype(np.float32) if external else None
    t_base5 = None if base5 is None else torch.from_numpy(base5)
    sums = ck.factorized_scan(torch.from_numpy(px), t_base5, radius=radius,
                              perceptual=perceptual)
    assert sums.shape == (B, (2 * radius + 1) ** 3 * 8)
    want_sums = np.asarray(jax.jit(_xla_scan, static_argnums=(2, 3, 4))(
        jnp.asarray(px), None if base5 is None else jnp.asarray(base5),
        radius, perceptual, True))
    if perceptual:
        # 3 x the sums is the error's share: held to the scan's tolerance
        _assert_scan_close(3.0 * sums.numpy(), 3.0 * want_sums, px, base5,
                           radius, perceptual)
    else:
        np.testing.assert_array_equal(sums.numpy(), want_sums)
    got = ck.factorized_scan_errors_reference(torch.from_numpy(px), t_base5,
                                              radius=radius,
                                              perceptual=perceptual)
    assert got.shape == sums.shape
    pallas = pallas_etc1s.factorized_scan(
        jnp.asarray(px), None if base5 is None else jnp.asarray(base5),
        radius=radius, interpret=True, perceptual=perceptual)
    _assert_scan_close(got.numpy(), np.asarray(pallas), px, base5, radius,
                       perceptual)
    _assert_scan_close(got.numpy(), np.asarray(_xla_scan(
                           jnp.asarray(px), base5, radius, perceptual)),
                       px, base5, radius, perceptual)


def _saturated_blocks(n, seed):
    """Blocks whose every channel sits at one end of the gamut (0..3 or
    252..255): the 5-bit base is 0 or 31 on each channel, so deltas clip to
    the same colour and their columns tie exactly, at the k-th place too."""
    rng = np.random.default_rng(seed)
    side = rng.integers(0, 2, (n, 1, 3))
    low = rng.integers(0, 4, (n, 16, 3))
    return np.where(side == 1, 255 - low, low).astype(np.float32)


def _pallas_top_k(px, radius, perceptual, k):
    """The reference's shortlist: the Pallas scan (interpret mode), then
    `lax.top_k(-flat, k)` as in `basis_universal_tpu/ops/etc1s_encode.py`
    encode_blocks."""
    flat = pallas_etc1s.factorized_scan(jnp.asarray(px), radius=radius,
                                        interpret=True, perceptual=perceptual)
    return np.asarray(jax.lax.top_k(-flat, k)[1])


def _equal_but_at_ties(got, px, radius, perceptual):
    """got (B, k) shortlist indices against the reference's: where they
    differ, the two columns' scores must tie within the scan's tolerance.
    Returns the number of rows that differ."""
    want = _pallas_top_k(px, radius, perceptual, got.shape[1])
    flat = ck.factorized_scan_errors_reference(
        torch.from_numpy(px), radius=radius, perceptual=perceptual).numpy()
    mag = scan_term_magnitude(torch.from_numpy(px), None, radius,
                              perceptual).numpy().astype(np.float64)
    rows = np.arange(px.shape[0])[:, None]
    a = flat[rows, got].astype(np.float64)
    b = flat[rows, want].astype(np.float64)
    tol = 2 * (RTOL * np.abs(b) + SCAN_MAG_TOL * mag[rows, want])
    differ = got != want
    assert np.all(np.abs(a - b)[differ] <= tol[differ]), "differs off a tie"
    return int(differ.any(1).sum())


@pytest.mark.parametrize("perceptual", [False, True])
@pytest.mark.parametrize("radius", [0, 1, 2])
def test_factorized_scan_shortlist_matches_plain_and_pallas(radius,
                                                           perceptual):
    """The fused scan + shortlist equals `_shortlist` of the plain scan, and
    the reference's Pallas scan + lax.top_k except where two columns' scores
    tie within the scan's tolerance (the tie count is printed)."""
    px = _blocks(B, 61 + radius)
    k = min(16, (2 * radius + 1) ** 3 * 8)
    got = ck.factorized_scan_shortlist(torch.from_numpy(px), radius=radius,
                                       perceptual=perceptual)
    assert got.shape == (B, k) and got.dtype == torch.int64
    flat = ck.factorized_scan_errors_reference(
        torch.from_numpy(px), radius=radius, perceptual=perceptual)
    assert torch.equal(got, tops._shortlist(flat, k))
    ties = _equal_but_at_ties(got.numpy(), px, radius, perceptual)
    print(f"shortlist r{radius} perceptual={perceptual}: {ties} of {B} rows "
          "ordered differently from Pallas + lax.top_k at ties")


@pytest.mark.parametrize("perceptual", [False, True])
@pytest.mark.parametrize("radius", [1, 2])
def test_factorized_scan_shortlist_ties_go_to_the_lower_column(radius,
                                                              perceptual):
    """Saturated blocks tie exactly across the k-th place: the lower column
    wins, as in a lexicographic (score, column) order and in lax.top_k."""
    px = _saturated_blocks(B, 70 + radius)
    got = ck.factorized_scan_shortlist(torch.from_numpy(px), radius=radius,
                                       perceptual=perceptual).numpy()
    flat = ck.factorized_scan_errors_reference(
        torch.from_numpy(px), radius=radius, perceptual=perceptual).numpy()
    s = np.sort(flat, 1)
    tied = s[:, 15] == s[:, 16]
    assert tied.sum() >= B // 10, "the set must tie at the 16th place"
    cols = np.arange(flat.shape[1])
    lex = np.stack([np.lexsort((cols, row))[:16] for row in flat])
    np.testing.assert_array_equal(got, lex)
    ties = _equal_but_at_ties(got, px, radius, perceptual)
    print(f"saturated r{radius} perceptual={perceptual}: {int(tied.sum())} "
          f"of {B} rows tie at the 16th place; {ties} rows ordered "
          "differently from Pallas + lax.top_k at ties")


def test_factorized_scan_shortlist_rejects_bad_k_and_radius():
    px = torch.from_numpy(_blocks(8, 1))
    for radius, k in ((1, 17), (2, 17), (0, 9), (1, 0)):
        with pytest.raises(ValueError):
            ck.factorized_scan_shortlist(px, radius=radius, k=k)
    with pytest.raises(ValueError):
        ck.factorized_scan_shortlist(px, radius=3)
    with pytest.raises(ValueError):
        ck.factorized_scan_shortlist(px, base5=torch.zeros((7, 3)))
    with pytest.raises(TypeError):
        ck.factorized_scan_shortlist(px.double())
    assert ck.factorized_scan_shortlist(px, radius=0).shape == (8, 8)
    assert ck.factorized_scan_shortlist(px, radius=2, k=3).shape == (8, 3)


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


# The selector kernel (`selbest_wgmma_kernel` in csrc/etc1s_kernels.cu),
# mirrored step by step: the producer's one-hot tile in shared memory, the
# tile as wgmma reads it through the kernel's descriptor, the A registers as
# the consumers load them, the product through the accumulator layout and
# the consumers' fold into the argmin. The layouts the hardware takes are
# written as the PTX ISA gives them, independently of the kernel's indexing.
SEL_N = 128                  # patterns a tile, `kSelN`


def _cuda_source():
    return (pathlib.Path(ck.__file__).resolve().parent.parent / "csrc"
            / "etc1s_kernels.cu").read_text()


def _onehot_pixel(u):
    """`onehot_pixel`: 0x3F80 (bf16 1.0) shifted left by 16 (u & 3) bits in
    64, as its low and high words, (..., 2)."""
    w = 0x3F80 << (16 * (u & 3))
    return torch.stack([w & 0xFFFFFFFF, w >> 32], -1)


def _selector_tile(patterns, tile):
    """(SEL_N * 128,) uint8: tile `tile` of the one-hot as the producer
    warpgroup stores it. Thread p takes quarter q = p & 3 (pixels 4q..4q+3,
    one 16-byte load) of patterns r = (p >> 2) + 32h of the tile and stores
    two 16-byte chunks in row r (128 bytes a pattern): the words of pixels
    4q, 4q+1 at chunk (2q) ^ (r & 7), those of pixels 4q+2, 4q+3 at chunk
    (2q+1) ^ (r & 7); past S, bf16 NaN at every k."""
    s_n = patterns.shape[0]
    p = torch.arange(128)
    q = (p & 3)[:, None].expand(128, SEL_N // 32)
    r = (p >> 2)[:, None] + 32 * torch.arange(SEL_N // 32)[None, :]
    n = tile * SEL_N + r
    sel = torch.zeros((128, SEL_N // 32, 4), dtype=torch.int64)
    ok = n < s_n
    sel[ok] = patterns.long().reshape(s_n, 4, 4)[n[ok], q[ok]]
    words = _onehot_pixel(sel).reshape(128, SEL_N // 32, 2, 4)
    words[~ok] = 0x7FC07FC0                             # bf16 NaN pairs
    mem = torch.zeros(SEL_N * 32, dtype=torch.int64)    # 32-bit words
    for half in (0, 1):
        addr = r * 128 + (((2 * q + half) ^ (r & 7)) << 4)
        mem[(addr // 4)[..., None] + torch.arange(4)] = words[:, :, half]
    return torch.stack([(mem >> (8 * b)) & 0xFF for b in range(4)],
                       -1).reshape(-1).to(torch.uint8)


def _sw128_desc(addr):
    """`sw128_desc`: start address >> 4, leading byte offset 1, stride byte
    offset 1,024 >> 4, layout type 1 (the 128-byte swizzle)."""
    return ((addr & 0x3FFFF) >> 4) | (1 << 16) | ((1024 >> 4) << 32) | (1 << 62)


def _wgmma_b(smem, desc):
    """(SEL_N, 64) bfloat16: B as wgmma reads it from shared memory
    (`smem`, bytes from address 0) for the descriptor of k-step 0 (k-step
    ks uses desc + 2 ks). K-major with the 128-byte swizzle: element (n, kk)
    of a k-step lies at start + (n % 8) * 128 + (n // 8) * SBO + 2 kk, and
    the address's bits 4-6 are XORed with its bits 7-9."""
    assert desc >> 62 == 1                       # 128-byte swizzle
    sbo = ((desc >> 32) & 0x3FFF) << 4
    n = torch.arange(SEL_N)[:, None]
    k = torch.arange(64)[None, :]
    start = ((desc + 2 * (k // 16)) & 0x3FFF) << 4
    addr = start + (n % 8) * 128 + (n // 8) * sbo + 2 * (k % 16)
    addr = addr ^ (((addr >> 7) & 7) << 4)
    half = smem[addr].long() | (smem[addr + 1].long() << 8)
    return half.to(torch.int16).view(torch.bfloat16)


def _plain_onehot(patterns, n_rows):
    """The plain version's (n_rows, 64) one-hot as bfloat16, rows past S
    NaN (the producer's padding)."""
    s_n = patterns.shape[0]
    out = torch.full((n_rows, 64), float("nan"), dtype=torch.bfloat16)
    out[:s_n] = torch.nn.functional.one_hot(patterns.long(), 4).reshape(
        s_n, 64).to(torch.bfloat16)
    return out


@pytest.mark.parametrize("s", [1, 7, SEL_N - 1, SEL_N, SEL_N + 1, 2731])
def test_selector_tile_mirror_holds_the_plain_one_hot(s):
    """Every tile the producer builds, read back as wgmma reads it through
    the kernel's descriptor (the ring's stages are 1,024-aligned), is the
    plain version's one-hot of the tile's patterns; past S, up to the
    tile's end, NaN, so those columns' errors are NaN, which the fold
    skips."""
    rng = np.random.default_rng(s)
    pats = torch.from_numpy(rng.integers(0, 4, (s, 16)).astype(np.int32))
    n_tiles = -(-s // SEL_N)
    want = _plain_onehot(pats, n_tiles * SEL_N).view(torch.int16)
    for j in range(n_tiles):
        stage = j % 4
        smem = torch.zeros(4 * SEL_N * 128 + 2048, dtype=torch.uint8)
        tile = 1024 + stage * SEL_N * 128
        smem[tile:tile + SEL_N * 128] = _selector_tile(pats, j)
        got = _wgmma_b(smem, _sw128_desc(tile)).view(torch.int16)
        assert torch.equal(got, want[j * SEL_N:(j + 1) * SEL_N]), j


def _ptx_a_coords():
    """The PTX ISA's register fragment of wgmma's A (m64nNk16, bf16): the
    (row, column) of half h of register j of warpgroup thread T: warp
    T // 32 holds rows 16 (T // 32) .. + 15; in it, groupID = lane / 4 and
    threadID_in_group = lane % 4 place a0..a7 at rows groupID (a0, a1, a4,
    a5) and groupID + 8 (a2, a3, a6, a7), columns 2 threadID_in_group + (0,
    1) (a0..a3) and + 8 (a4..a7); register j holds a_{2j}, a_{2j+1}."""
    T = torch.arange(128)[:, None, None]
    j = torch.arange(4)[None, :, None]
    h = torch.arange(2)[None, None, :]
    lane = T % 32
    a_idx = 2 * j + h
    row = 16 * (T // 32) + lane // 4 + 8 * ((a_idx // 2) % 2)
    col = 2 * (lane % 4) + (a_idx % 2) + 8 * (a_idx // 4)
    return row.expand(128, 4, 2), col.expand(128, 4, 2)


def _ptx_d_coords(n):
    """The PTX ISA's wgmma accumulator (m64nNk16, f32): register i of
    thread T is row 16 (T // 32) + lane / 4 + 8 ((i % 4) >= 2), column
    8 (i // 4) + 2 (lane % 4) + i % 2."""
    T = torch.arange(128)[:, None]
    i = torch.arange(n // 2)[None, :]
    lane = T % 32
    row = 16 * (T // 32) + lane // 4 + 8 * ((i % 4) >= 2).long()
    col = 8 * (i // 4) + 2 * (lane % 4) + i % 2
    return row, col


def _kernel_a_regs(d_rows):
    """The consumers' A registers, (128 threads, 4 k-steps, 4, 2) as the
    kernel loads them: register r + 2c of k-step ks of thread (warp w, g,
    t) holds row 16w + g + 8r, the float2 at ks*8 + t + 4c of the row
    (columns 16 ks + 2t + 8c, + 1), rounded to bf16."""
    out = torch.zeros((128, 4, 4, 2), dtype=torch.bfloat16)
    d = d_rows.to(torch.bfloat16)
    for T in range(128):
        w, g, t = T // 32, (T % 32) // 4, T % 4
        for ks in range(4):
            for r in range(2):
                for c in range(2):
                    f2 = ks * 8 + t + 4 * c
                    out[T, ks, r + 2 * c] = d[16 * w + g + 8 * r,
                                              2 * f2:2 * f2 + 2]
    return out


def _kernel_acc_coords(n):
    """The consumers' reading of the accumulator: register 4i + 2r + e of
    thread (warp w, g, t) is row 16w + g + 8r, column 8i + 2t + e."""
    row = torch.zeros((128, n // 2), dtype=torch.long)
    col = torch.zeros((128, n // 2), dtype=torch.long)
    for T in range(128):
        w, g, t = T // 32, (T % 32) // 4, T % 4
        for i in range(n // 8):
            for r in range(2):
                for e in range(2):
                    row[T, 4 * i + 2 * r + e] = 16 * w + g + 8 * r
                    col[T, 4 * i + 2 * r + e] = 8 * i + 2 * t + e
    return row, col


@pytest.mark.parametrize("s", [37, 300])
def test_selector_accumulator_mirror_gives_the_plain_errors(s):
    """A warpgroup's product through the layouts: the A registers the
    kernel loads are, by the PTX ISA's fragment layout, the bf16 distances
    of its 64 rows, each once; the product with each B tile (built by the
    producer, read through the descriptor) lands in the accumulator by the
    PTX ISA's layout; and the kernel's (row, column) of each accumulator
    register gives back the plain version's error matrix, every value."""
    rng = np.random.default_rng(s)
    d = torch.from_numpy((rng.random((64, 64)) * 5000.0).astype(np.float32))
    pats = torch.from_numpy(rng.integers(0, 4, (s, 16)).astype(np.int32))
    regs = _kernel_a_regs(d)
    a_row, a_col = _ptx_a_coords()
    a_hw = torch.full((64, 64), float("nan"))
    for ks in range(4):
        a_hw[a_row, 16 * ks + a_col] = regs[:, ks].float()
    assert torch.equal(a_hw, d.to(torch.bfloat16).float())
    d_row, d_col = _ptx_d_coords(SEL_N)
    k_row, k_col = _kernel_acc_coords(SEL_N)
    plain = d.to(torch.bfloat16).double() @ _plain_onehot(pats, s).double().T
    for j in range(-(-s // SEL_N)):
        smem = torch.zeros(SEL_N * 128 + 1024, dtype=torch.uint8)
        smem[1024:] = _selector_tile(pats, j)
        b_hw = _wgmma_b(smem, _sw128_desc(1024)).double()
        acc = (a_hw.double() @ b_hw.T)[d_row, d_col]          # (128, N/2)
        got = torch.full((64, SEL_N), float("nan"), dtype=torch.float64)
        got[k_row, k_col] = acc
        n_valid = min(SEL_N, s - j * SEL_N)
        assert torch.equal(got[:, :n_valid],
                           plain[:, j * SEL_N:j * SEL_N + n_valid])


def _selector_fold(err, s):
    """The consumers' argmin over an (R, S) error matrix, as the kernel
    folds it (`sel_fold`): tile by tile (past S the columns are NaN), the
    row's least value over the tile (each thread's columns 8i + 2t + e,
    then its quad; NaN skipped, as fminf does) replaces the row's running
    value where strictly below it, with the least column holding it over
    the quad's threads, each thread's first in increasing order; a row with
    no finite error gives pattern 0 and +inf."""
    n_rows = err.shape[0]
    n_tiles = -(-s // SEL_N)
    e = torch.full((n_rows, n_tiles * SEL_N), float("nan"))
    e[:, :s] = err
    inf = float("inf")
    bv = torch.full((n_rows,), inf)
    bi = torch.full((n_rows,), 0x7FFFFFFF, dtype=torch.long)
    i = torch.arange(SEL_N // 8)[:, None]
    ee = torch.arange(2)[None, :]
    for j in range(n_tiles):
        m_t, c_t = [], []
        for t in range(4):
            cols = (8 * i + 2 * t + ee).reshape(-1)           # increasing
            v = e[:, j * SEL_N + cols]
            m = torch.where(torch.isnan(v), inf, v).min(1).values
            m_t.append(torch.where(torch.isnan(v).all(1), float("nan"), m))
            c_t.append((v, cols))
        m = m_t[0]
        for t in range(1, 4):                                 # fminf
            m = torch.where(torch.isnan(m), m_t[t],
                            torch.where(torch.isnan(m_t[t]), m,
                                        torch.minimum(m, m_t[t])))
        take = m < bv
        col = torch.full((n_rows,), 1 << 20, dtype=torch.long)
        for v, cols in c_t:
            hit = v == m[:, None]
            first = torch.where(hit.any(1), cols[hit.long().argmax(1)],
                                1 << 20)
            col = torch.minimum(col, first)
        bv = torch.where(take, m, bv)
        bi = torch.where(take, j * SEL_N + col, bi)
    return torch.where(bi == 0x7FFFFFFF, 0, bi).to(torch.int32), bv


@pytest.mark.parametrize("s", [7, SEL_N + 1, 300])
def test_selector_fold_mirror_matches_the_plain_argmin(s):
    """The kernel's fold gives the plain version's (index, value): the
    first index of the least error. The errors are small whole numbers
    with duplicated patterns, so most rows tie exactly, within a thread's
    columns, across a quad and across tiles; a row of +inf errors and one
    of NaN errors give pattern 0 and +inf."""
    rng = np.random.default_rng(s)
    n_rows = 200
    d = torch.from_numpy(rng.integers(0, 3, (n_rows, 64)).astype(np.float32))
    m = -(-s // 2)
    pats = torch.from_numpy(rng.integers(0, 4, (m, 16))[np.arange(s) % m])
    err = d @ _plain_onehot(pats, s).float().T
    err[5] = float("inf")
    err[6] = float("nan")
    best, val = _selector_fold(err, s)
    want_val, want_best = err[:5].min(1)
    assert torch.equal(best[:5].long(), want_best)
    assert torch.equal(val[:5], want_val)
    plain_b, plain_v = ck.find_best_selector_patterns_reference(
        d.reshape(n_rows, 16, 4)[7:], pats, s)
    assert torch.equal(best[7:], plain_b) and torch.equal(val[7:], plain_v)
    assert best[5] == 0 and best[6] == 0
    assert val[5] == float("inf") and val[6] == float("inf")
    assert not torch.any(best >= m)          # never a later twin


def test_selector_unsigned_minimum_is_the_float_minimum():
    """The fold's integer path: errors of +0 or more, +inf and NaN (the
    padding, the products of an infinite distance), taken as unsigned
    32-bit integers, have the float order, NaN above everything, so their
    unsigned minimum is the minimum fminf finds (which skips NaN), and NaN
    only where every value is NaN; a negative value breaks that order,
    which is why the kernel takes that path only where no distance has its
    sign bit set."""
    rng = np.random.default_rng(8)
    err = torch.from_numpy((rng.random((500, 32)) * 3e5).astype(np.float32))
    err[rng.random((500, 32)) < 0.2] = float("nan")
    err[rng.random((500, 32)) < 0.1] = float("inf")
    err[rng.random((500, 32)) < 0.05] = 0.0
    err[7] = float("nan")
    bits = err.view(torch.int32).long() & 0xFFFFFFFF
    got = bits.min(1).values.to(torch.int64)
    got = torch.where(got >= 2 ** 31, got - 2 ** 32, got).to(torch.int32)
    got = got.view(torch.float32)
    want = torch.where(torch.isnan(err), float("inf"), err).min(1).values
    assert torch.equal(got[torch.arange(500) != 7], want[torch.arange(500) != 7])
    assert torch.isnan(got[7])
    neg = torch.tensor([-1.0, 2.0])
    u = neg.view(torch.int32).long() & 0xFFFFFFFF
    assert int(u.argmin()) == 1                       # the order breaks


def test_selector_mirrors_follow_the_cuda_source():
    """The mirrors above repeat the kernel's own constants and index
    arithmetic: the tile width, the producer's chunks and swizzle, the
    one-hot words and the NaN past S, the descriptor and its k-step, the A
    loads, the accumulator's reading and the fold's first column; and the
    Ampere instruction the kernel used before is gone."""
    src = _cuda_source()
    for piece in (f"constexpr int kSelN = {SEL_N};",
                  "const int q = p & 3;",
                  "const int r = (p >> 2) + 32 * h;",
                  "const int n = j * kSelN + (p >> 2) + 32 * h;",
                  "j < n_tiles && n < n_patterns",
                  "reinterpret_cast<const uint4*>(patterns + (size_t)n * 16) + q)",
                  "const uint32_t row = tile + r * 128;",
                  "const int sw = r & 7;",
                  "st_shared_v4(row + (((2 * q) ^ sw) << 4), a0.x, a0.y, a1.x, a1.y);",
                  "st_shared_v4(row + (((2 * q + 1) ^ sw) << 4), a2.x, a2.y, a3.x,",
                  "onehot_pixel(v[h].x), a1 = onehot_pixel(v[h].y);",
                  "onehot_pixel(v[h].z), a3 = onehot_pixel(v[h].w);",
                  "if (j * kSelN + r >= n_patterns) {",
                  "a0 = a1 = a2 = a3 = make_uint2(0x7FC07FC0u, 0x7FC07FC0u);",
                  "(uint64_t)0x3F80u << ((u & 3u) << 4);",
                  "return make_uint2((uint32_t)w, (uint32_t)(w >> 32));",
                  "((uint64_t)(1024 >> 4) << 32) | ((uint64_t)1 << 62)",
                  "((uint64_t)1 << 16)",
                  "wgmma_tile(acc, a[ks], desc + 2 * ks, ks);",
                  "sel_issue(acc, a, j, ring, full0);",
                  "wgmma_wait_all();",
                  "sel_fold(acc, j * kSelN, t, nonneg, bv, bi);",
                  "const bool nonneg = !__any_sync(0xffffffffu, sign >> 31);",
                  "sign |= __float_as_uint(v.x) | __float_as_uint(v.y);",
                  "u[i & 1] = __vimin3_u32(u[i & 1], __float_as_uint(acc[4 * i + 2 * r]),",
                  f"wgmma.mma_async.sync.aligned.m64n{SEL_N}k16.f32.bf16.bf16",
                  "__ldg(src + ks * 8 + t + 4 * c)",
                  "a[ks][r + 2 * c] =",
                  "const int row0 = blockIdx.x * kSelRows + wg * 64 + warp * 16;",
                  "c = acc[4 * i + 2 * r + e] == m ? 8 * i + e : c;",
                  "c += 2 * t;",
                  "c = min(c, __shfl_xor_sync(0xffffffffu, c, 1));",
                  "c = min(c, __shfl_xor_sync(0xffffffffu, c, 2));",
                  "m = fminf(m, __shfl_xor_sync(0xffffffffu, m, 1));",
                  "m = fminf(m, __shfl_xor_sync(0xffffffffu, m, 2));",
                  "bi[r] = better ? base + c : bi[r];",
                  "const bool better = m < bv[r];"):
        assert piece in src, piece
    assert "mma.sync" not in src and "selbest_mma_kernel" not in src
    # the 1,024-byte aligned ring, one tile a stage
    assert "(smem_u32(sel_smem) + 1023u) & ~1023u" in src
    assert "constexpr int kSelTileBytes = kSelN * 128;" in src


def test_min_k_shared_memory_limit_matches_the_cuda_source():
    """The wrapper allocates global scratch for exactly the rows that the
    kernel does not sort in shared memory."""
    src = (pathlib.Path(ck.__file__).resolve().parent.parent / "csrc"
           / "etc1s_kernels.cu").read_text()
    got = re.search(r"constexpr int kMinKSmemN = (\d+);", src).group(1)
    assert int(got) == ck._MIN_K_SMEM_N
    # rows in shared memory keep their columns and swap lists in 16 bits
    assert "std::conditional<kShared, uint16_t, int>" in src
    assert ck._MIN_K_SMEM_N <= 1 << 16


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
    defs = dict(re.findall(r"#define (\w+) (-?[\d.]+(?:e[-+]?\d+)?)f", src))
    for i in range(3):
        for j in range(3):
            assert np.float32(defs[f"P{i}{j}"]) == tops.PERC_P[i, j]
    for i in range(3):
        assert np.float32(defs[f"G{i}"]) == tops.GVEC[i]
    assert "kPercTailBit = 1 << 18;" in src
    assert tops.PERC_TAIL_BIT == 1 << 18
    assert np.float32(defs["THIRD"]) == np.float32(1.0 / 3.0)
    assert np.float32(defs["C31_255"]) == np.float32(31.0 / 255.0)


def test_bisect_row_layout_matches_the_cuda_source():
    """The member rows of the bisecting init: the CUDA source's row width
    is the wrappers', and its index of each moment sum (v_f v_g) w takes the
    21 pairs in order; the plain member rows hold v and w, and their moment
    columns w, v w and the products, rounded as the reference rounds them
    (the coordinates' product, then by the weight)."""
    src = (pathlib.Path(ck.__file__).resolve().parent.parent / "csrc"
           / "etc1s_kernels.cu").read_text()
    assert f"constexpr int kBisectM = {ck.BISECT_M};" in src
    # the kernel's index of the sum of (v_f v_g) w, f <= g: the 21 pairs in
    # row-major order after w and the 6 v_f w
    assert "7 + f * 6 - f * (f - 1) / 2 + (g - f);   // f <= g" in src
    cols = [7 + f * 6 - f * (f - 1) // 2 + (g - f)
            for f in range(6) for g in range(f, 6)]
    assert cols == list(range(7, 28))
    rng = np.random.default_rng(4)
    v = rng.uniform(0, 1, (9, 6)).astype(np.float32)
    w = rng.uniform(0.5, 2, 9).astype(np.float32)
    members, starts = ck.bisect_rows(torch.from_numpy(v), torch.from_numpy(w))
    assert starts.tolist() == [0, 9] and members.shape == (9, ck.BISECT_M)
    np.testing.assert_array_equal(members[:, :6].numpy(), v)
    np.testing.assert_array_equal(members[:, 6].numpy(), w)
    assert not members[:, 7].any()
    mom = ck.bisect_moments(members).numpy()
    np.testing.assert_array_equal(mom[:, 0], w)
    np.testing.assert_array_equal(mom[:, 1:7], v * w[:, None])
    for f in range(6):
        for g in range(6):
            np.testing.assert_array_equal(mom[:, 7 + 6 * f + g],
                                          (v[:, f] * v[:, g]) * w)


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
        ck.palette_errs_packed(px, torch.zeros((8, 257), dtype=torch.int32))
    with pytest.raises(ValueError):
        ck.palette_errs(px, torch.zeros((8, 4, 3, 3)))
    with pytest.raises(TypeError):
        ck.palette_errs(px, torch.zeros((8, 4, 4, 3), dtype=torch.float64))
    with pytest.raises(ValueError):
        ck.find_best_selector_patterns(torch.zeros((8, 16, 4)),
                                       torch.zeros((5, 16), dtype=torch.int32),
                                       6)
    with pytest.raises(ValueError):
        ck.bisect_rows(torch.zeros((8, 5)), torch.ones(8))
    with pytest.raises(TypeError):
        ck.bisect_rows(torch.zeros((8, 6), dtype=torch.float64), torch.ones(8))
    with pytest.raises(ValueError):
        ck.bisect_rows(torch.zeros((8, 6)), torch.ones(7))
    one = torch.tensor([0, 8], dtype=torch.int32)
    with pytest.raises(ValueError):
        ck.bisect_round(torch.zeros((8, 7)), one)
    with pytest.raises(TypeError):
        ck.bisect_round(torch.zeros((8, 8), dtype=torch.float64), one)
    with pytest.raises(TypeError):
        ck.bisect_round(torch.zeros((8, 8)), torch.tensor([0, 8]))
    with pytest.raises(ValueError):
        ck.bisect_round(torch.zeros((8, 8)), one[1:])

def test_cpu_tensors_run_the_plain_version_without_launching():
    ck.reset_launch_counts()
    px = torch.from_numpy(_blocks(40, 9))
    np.testing.assert_array_equal(
        ck.factorized_scan(px).numpy(),
        ck.factorized_scan_reference(px).numpy())
    for radius in (0, 1):
        np.testing.assert_array_equal(
            ck.factorized_scan_shortlist(px, radius=radius).numpy(),
            ck.factorized_scan_shortlist_reference(px, radius=radius).numpy())
    packed = torch.from_numpy(_packed(40, 4, 1))
    np.testing.assert_array_equal(
        ck.palette_errs_packed(px, packed).numpy(),
        ck.palette_errs_packed_reference(px, packed).numpy())
    pal = torch.from_numpy(_explicit_palettes(_packed(40, 4, 2)))
    np.testing.assert_array_equal(
        ck.palette_errs(px, pal).numpy(),
        ck.palette_errs_reference(px, pal).numpy())
    vecs = torch.from_numpy(np.random.default_rng(3).uniform(
        0, 1, (40, 6)).astype(np.float32))
    rows = ck.bisect_rows(vecs, torch.ones(40))
    for got, want in zip(rows, ck.bisect_rows_reference(vecs, torch.ones(40))):
        np.testing.assert_array_equal(got.numpy(), want.numpy())
    for got, want in zip(ck.bisect_round(*rows, last=True),
                         ck.bisect_round_reference(*rows, last=True)):
        np.testing.assert_array_equal(got.numpy(), want.numpy())
    assert all(v == 0 for v in ck.LAUNCHES.values())


def test_xla_order_layout_merges_contiguous_dims():
    """The card wrappers of `ops/xla_order.py` hand their kernels an output
    shape with size-1 dims dropped and dims every operand steps through
    contiguously merged, and each operand's strides over it (0 where
    broadcast), as one int64 buffer: 8 sizes, then 8 strides per operand."""
    from basis_universal_tpu_torch.ops import xla_order as xo

    a, row = torch.zeros((4, 5, 6)), torch.zeros(6)
    shape, strides = xo._broadcast([a, 2.0, row])
    assert shape == [4, 5, 6] and strides == [[30, 6, 1], None, [0, 0, 1]]
    nd, meta = xo._layout(shape, strides)
    assert nd == 2 and list(meta[:2]) == [20, 6]
    assert list(meta[8:10]) == [6, 1] and list(meta[16:18]) == [0, 0]
    assert list(meta[24:26]) == [0, 1]
    shape, strides = xo._broadcast([a[:, :1, :], torch.zeros((5, 1))])
    assert shape == [4, 5, 6] and strides == [[30, 0, 1], [0, 1, 0]]
    nd, meta = xo._layout(*xo._broadcast([torch.zeros(())]))
    assert nd == 1 and meta[0] == 1
    with pytest.raises(ValueError):
        xo._broadcast([torch.zeros((2, 3)), torch.zeros((4, 3))])
    odd = torch.zeros((2,) * 9).permute(8, 7, 6, 5, 4, 3, 2, 1, 0)
    with pytest.raises(ValueError):
        xo._layout(*xo._broadcast([odd, torch.zeros((2,) * 9)]))


@pytest.mark.parametrize("n_ops", [1, 2, 3])
def test_xla_order_layout_holds_three_operands(n_ops):
    """The kernels read three operands' strides from the layout buffer
    (`layout32_of` in `csrc/xla_order_kernels.cu`): an ordered sum of one
    operand or a product sum of two gets zeros for the rest, not bytes past
    the buffer, which chose between the 32- and the 64-bit kernel."""
    from basis_universal_tpu_torch.ops import xla_order as xo

    ops = [torch.zeros((24, 16, 3)), torch.zeros((24, 16, 1)), 2.0][:n_ops]
    nd, meta = xo._layout(*xo._broadcast(ops))
    assert nd == (1 if n_ops == 1 else 2)
    assert len(meta) == 4 * 8
    assert list(meta[8 * (1 + min(n_ops, 2)):]) == [0] * 8 * (3 - min(n_ops, 2))
