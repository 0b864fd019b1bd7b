"""Every function of `basis_universal_tpu_torch/ops/etc1s_encode.py` against
its JAX counterpart in `basis_universal_tpu/ops/etc1s_encode.py`, on the CPU.

The two take different formulations where the reference does: on the CPU the
reference runs its XLA branches, the port its kernel-shaped one (through the
kernels' plain versions). Seeds, codebooks and the random fill of
`bisecting_init` go to both through `utils/state.py`.

Tolerances: floats rtol 1e-5 (matmul-based distances, whose terms cancel,
against |want| + the magnitude of the cancelled terms); indices equal except
where the two choices' errors tie within that tolerance; the tie count is
printed.
"""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from basis_universal_tpu.ops import etc1s_encode as jops
from basis_universal_tpu.ops.etc1 import ETC1_INTEN_TABLES, etc1s_palette
from basis_universal_tpu_torch.ops import etc1s_encode as tops
from basis_universal_tpu_torch.utils import state

RTOL = 1e-5


def _t(x):
    return torch.from_numpy(np.array(x, copy=True))


def _blocks(n, seed):
    rng = np.random.default_rng(seed)
    px = rng.integers(0, 256, (n, 1, 3)) + rng.integers(-30, 31, (n, 16, 3))
    px[: n // 8] = rng.integers(0, 256, (n // 8, 16, 3))
    return np.clip(px, 0, 255).astype(np.float32)


def _block_errors(px, color5, inten, perceptual=False):
    """Exact clipped ETC1S error of each block (B,16,3) against the endpoint
    (color5 (B,3), inten (B,)), float64, the difference taken through
    PERC_P when perceptual."""
    pal = etc1s_palette(color5, inten).astype(np.float64)          # (B,4,3)
    diff = px[:, :, None, :] - pal[:, None, :, :]
    if perceptual:
        diff = diff @ jops.PERC_P.astype(np.float64).T
    return (diff ** 2).sum(-1).min(-1).sum(-1)


def test_perceptual_transform_and_constants():
    np.testing.assert_array_equal(tops.PERC_P, jops.PERC_P)
    x = np.random.default_rng(0).uniform(0, 255, (50, 16, 3)).astype(np.float32)
    np.testing.assert_allclose(tops.perceptual_transform(_t(x)).numpy(),
                               np.asarray(jops.perceptual_transform(x)),
                               rtol=RTOL, atol=1e-3)
    for r in (0, 1, 2):
        np.testing.assert_array_equal(tops._candidate_deltas(r),
                                      jops._candidate_deltas(r))
    c5 = np.arange(32, dtype=np.int32)
    np.testing.assert_array_equal(tops.expand5(_t(c5)).numpy(),
                                  np.asarray(jops.expand5(jnp.asarray(c5))))


def test_gray_axis_minterm_and_block_moments():
    rng = np.random.default_rng(1)
    u = rng.uniform(-200, 200, (3, 40, 16)).astype(np.float32)
    np.testing.assert_allclose(tops._gray_axis_minterm(_t(u)).numpy(),
                               np.asarray(jops._gray_axis_minterm(u)),
                               rtol=RTOL)
    px = _blocks(60, 2)
    gvec = (jops.PERC_P @ np.ones(3, np.float32)).astype(np.float32)
    for g in (None, gvec):
        got = tops._block_moments(_t(px), None if g is None else _t(g))
        want = jops._block_moments(jnp.asarray(px),
                                   None if g is None else jnp.asarray(g))
        for k in want:
            np.testing.assert_allclose(got[k].numpy(), np.asarray(want[k]),
                                       rtol=RTOL)


@pytest.mark.parametrize("perceptual", [False, True])
@pytest.mark.parametrize("radius", [1, 0])
def test_encode_blocks(radius, perceptual):
    px = _blocks(500, 3 + radius)
    got = tops.encode_blocks(_t(px), radius=radius, perceptual=perceptual)
    want = jops.encode_blocks(jnp.asarray(px), radius=radius,
                              perceptual=perceptual)
    want = {k: np.asarray(v) for k, v in want.items()}
    got = {k: v.numpy() for k, v in got.items()}
    np.testing.assert_allclose(got["err"], want["err"], rtol=RTOL, atol=1e-2)
    same = (got["color5"] == want["color5"]).all(-1) & (got["inten"]
                                                         == want["inten"])
    # a different endpoint only where both score the same
    np.testing.assert_allclose(got["err"][~same], want["err"][~same],
                               rtol=RTOL, atol=1e-2)
    np.testing.assert_array_equal(got["low"][same], want["low"][same])
    np.testing.assert_array_equal(got["high"][same], want["high"][same])
    sel_same = (got["selectors"] == want["selectors"])[same]
    print(f"encode_blocks r{radius} perc={perceptual}: endpoint ties "
          f"{(~same).sum()}/500, selector ties {(~sel_same).sum()}")
    assert sel_same.mean() > 0.999
    assert got["color5"].dtype == np.int32 and got["selectors"].dtype == np.int32


@pytest.mark.parametrize("perceptual", [False, True])
def test_optimize_cluster_endpoints(perceptual):
    rng = np.random.default_rng(4)
    px = _blocks(600, 5)
    c = 45
    ids = rng.integers(0, 40, 600).astype(np.int32)        # 5 empty clusters
    cnt = np.bincount(ids, minlength=c)
    means = np.zeros((c, 3), np.float32)
    np.add.at(means, ids, px.mean(1))
    means /= np.maximum(cnt, 1)[:, None]
    g5, gi = tops.optimize_cluster_endpoints(
        _t(px), state.assignment(ids), _t(means), c, perceptual=perceptual)
    w5, wi = jops.optimize_cluster_endpoints(
        jnp.asarray(px), jnp.asarray(ids), jnp.asarray(means), c,
        perceptual=perceptual)
    g5, gi, w5, wi = g5.numpy(), gi.numpy(), np.asarray(w5), np.asarray(wi)
    same = (g5 == w5).all(-1) & (gi == wi)
    # where the choices differ, the clusters' exact errors tie
    for k in np.nonzero(~same)[0]:
        m = ids == k
        eg = _block_errors(px[m], np.repeat(g5[k:k + 1], m.sum(), 0),
                           np.repeat(gi[k:k + 1], m.sum()), perceptual).sum()
        ew = _block_errors(px[m], np.repeat(w5[k:k + 1], m.sum(), 0),
                           np.repeat(wi[k:k + 1], m.sum()), perceptual).sum()
        assert abs(eg - ew) <= RTOL * ew
    print(f"optimize_cluster_endpoints perc={perceptual}: ties {(~same).sum()}/{c}")
    assert same.mean() >= 0.95
    assert same[40:].all()           # empty clusters: the same default


def _kmeans_ties(vecs, cents, bf16, a, b):
    """Rows where assignments a and b are equally near (float64 distances
    from the operands as each formulation rounds them)."""
    vh, ch = vecs, cents
    if bf16:
        vh = np.asarray(jnp.asarray(vecs).astype(jnp.bfloat16).astype(jnp.float32))
        ch = np.asarray(jnp.asarray(cents).astype(jnp.bfloat16).astype(jnp.float32))
    d = (cents.astype(np.float64) ** 2).sum(-1)[None] - 2 * (
        vh.astype(np.float64) @ ch.astype(np.float64).T)
    r = np.arange(len(a))
    return np.abs(d[r, a] - d[r, b]) <= 1e-5 * (np.abs(d[r, b]) + 1.0)


@pytest.mark.parametrize("n,c", [(600, 40), (2400, 1024)])
def test_kmeans(n, c):
    """Lloyd steps one at a time from the same centroids: assignments equal
    except at ties; then both continue from the reference's centroids."""
    rng = np.random.default_rng(c)
    vecs = rng.uniform(0, 1, (n, 6)).astype(np.float32)
    w = np.ones(n, np.float32)
    cents = vecs[rng.choice(n, c, replace=False)]
    ties = 0
    for _ in range(2):
        gc, ga = tops.kmeans(_t(vecs), _t(w), state.vectors(cents), c, iters=1)
        wc, wa = jops.kmeans(jnp.asarray(vecs), jnp.asarray(w),
                             jnp.asarray(cents), c, iters=1)
        ga, wa = ga.numpy(), np.asarray(wa)
        differ = ga != wa
        assert _kmeans_ties(vecs, cents, c >= 1024, ga, wa)[differ].all()
        ties += int(differ.sum())
        if not differ.any():
            np.testing.assert_allclose(gc.numpy(), np.asarray(wc), rtol=RTOL,
                                       atol=1e-6)
        cents = np.asarray(wc)
    print(f"kmeans n={n} c={c}: assignment ties {ties}/{2 * n}")
    # the full call runs the same steps
    gc2, _ = tops.kmeans(_t(vecs), _t(w), state.vectors(vecs[:c]), c, iters=2)
    assert gc2.shape == (c, 6) and torch.isfinite(gc2).all()


@pytest.mark.parametrize("n,c", [(500, 40), (8, 16)])
def test_bisecting_init(n, c):
    """(8, 16): every leaf holds at most one vector, so half the seeds come
    from the random fill, which both sides take from the reference's draw."""
    rng = np.random.default_rng(n)
    vecs = rng.uniform(0, 1, (n, 6)).astype(np.float32)
    w = np.ones(n, np.float32)
    key = jax.random.PRNGKey(7)
    want = np.asarray(jops.bisecting_init(jnp.asarray(vecs), jnp.asarray(w),
                                          c, key))
    fill = np.asarray(jax.random.choice(key, jnp.asarray(vecs), (c,)))
    got = tops.bisecting_init(_t(vecs), _t(w), c,
                              fill=state.vectors(fill)).numpy()
    np.testing.assert_allclose(got, want, rtol=1e-4, atol=1e-6)
    # the port's own draw: seeds that needed a fill are training vectors
    own = tops.bisecting_init(_t(vecs), _t(w), c,
                              generator=torch.Generator().manual_seed(1))
    assert own.shape == (c, 6)
    assert all(np.isclose(vecs, r, rtol=1e-4, atol=1e-6).all(-1).any()
               or np.isclose(want, r, rtol=1e-4, atol=1e-6).all(-1).any()
               for r in own.numpy())


@pytest.mark.parametrize("perceptual", [False, True])
def test_refine_endpoint_assignment(perceptual):
    rng = np.random.default_rng(6)
    px = _blocks(400, 7)
    enc = jops.encode_blocks(jnp.asarray(px), radius=1)
    vec6 = np.concatenate([np.asarray(enc["low"]), np.asarray(enc["high"])],
                          -1) / 255.0
    c5 = rng.integers(0, 32, (60, 3)).astype(np.int32)
    it = rng.integers(0, 8, 60).astype(np.int32)
    c5[30] = c5[10]                  # a duplicate endpoint: an exact tie
    it[30] = it[10]
    pal = etc1s_palette(c5, it).astype(np.float32)
    cb6 = np.concatenate([pal[:, 0], pal[:, 3]], -1) / 255.0
    g5, gi = state.endpoint_codebook(c5, it)
    ga, ge = tops.refine_endpoint_assignment(
        _t(px), state.vectors(vec6), state.vectors(cb6), g5, gi, topk=8,
        perceptual=perceptual)
    wa, we = jops.refine_endpoint_assignment(
        jnp.asarray(px), jnp.asarray(vec6, jnp.float32),
        jnp.asarray(cb6), jnp.asarray(c5), jnp.asarray(it), topk=8,
        perceptual=perceptual)
    ga, ge, wa, we = ga.numpy(), ge.numpy(), np.asarray(wa), np.asarray(we)
    # every block's chosen error agrees, so where the chosen clusters
    # differ the two tie (equal palettes, or equal clipped errors)
    np.testing.assert_allclose(ge, we, rtol=RTOL, atol=1e-2)
    differ = ga != wa
    print(f"refine_endpoint_assignment perc={perceptual}: ties {differ.sum()}/400")


def test_selector_ops():
    rng = np.random.default_rng(8)
    px = _blocks(300, 9)
    pal = rng.uniform(0, 255, (300, 4, 3)).astype(np.float32)
    got = tops.block_selector_distances(_t(px), _t(pal)).numpy()
    want = np.asarray(jops.block_selector_distances(jnp.asarray(px),
                                                    jnp.asarray(pal)))
    np.testing.assert_allclose(got, want, rtol=RTOL)
    pats = rng.integers(0, 4, (90, 16)).astype(np.int32)
    gb, gv = tops.find_best_selector_patterns(_t(want), state.selector_patterns(pats), 90)
    wb, wv = jops.find_best_selector_patterns(jnp.asarray(want), jnp.asarray(pats), 90)
    np.testing.assert_array_equal(gb.numpy(), np.asarray(wb))
    np.testing.assert_allclose(gv.numpy(), np.asarray(wv), rtol=RTOL)
    assign = rng.integers(0, 90, 300).astype(np.int32)
    np.testing.assert_array_equal(
        tops.update_selector_patterns(_t(want), _t(assign), 90).numpy(),
        np.asarray(jops.update_selector_patterns(jnp.asarray(want),
                                                 jnp.asarray(assign), 90)))


def test_rdo_neighbor_copy():
    rng = np.random.default_rng(10)
    by, bx = 12, 15
    n = by * bx
    base = np.repeat(np.repeat(rng.integers(0, 256, (by // 3, bx // 3, 1, 3)),
                               3, 0), 3, 1).reshape(n, 1, 3)
    px = np.clip(base + rng.integers(-6, 7, (n, 16, 3)), 0, 255).astype(np.float32)
    c5 = rng.integers(0, 32, (50, 3)).astype(np.int32)
    it = rng.integers(0, 8, 50).astype(np.int32)
    cb_pal = etc1s_palette(c5, it).astype(np.float32)
    pats = rng.integers(0, 4, (40, 16)).astype(np.int32)
    assign = rng.integers(0, 50, n).astype(np.int32)
    sel = rng.integers(0, 40, n).astype(np.int32)
    idx = np.arange(n).reshape(by, bx)
    left = np.full((by, bx), -1, np.int32)
    left[:, 1:] = idx[:, :-1]
    up = np.full((by, bx), -1, np.int32)
    up[1:] = idx[:-1]
    left, up = left.ravel(), up.ravel()
    for e_t, s_t in ((1.35, 1.15), (3.0, 3.0)):
        ga, gs = tops.rdo_neighbor_copy(
            _t(px), state.assignment(assign), state.assignment(sel),
            _t(cb_pal), state.selector_patterns(pats), _t(left), _t(up),
            e_t, s_t)
        wa, ws = jops.rdo_neighbor_copy(
            jnp.asarray(px), jnp.asarray(assign), jnp.asarray(sel),
            jnp.asarray(cb_pal), jnp.asarray(pats), jnp.asarray(left),
            jnp.asarray(up), e_t, s_t)
        np.testing.assert_array_equal(ga.numpy(), np.asarray(wa))
        np.testing.assert_array_equal(gs.numpy(), np.asarray(ws))
        assert (ga.numpy() != assign).any()      # some copies happened


def test_state_dtypes_and_devices():
    c5, it = state.endpoint_codebook(np.zeros((4, 3), np.uint8),
                                     np.zeros(4, np.uint8))
    assert c5.dtype == torch.int32 and it.dtype == torch.int32
    assert state.selector_patterns(np.zeros((2, 16), np.uint8)).dtype == torch.int32
    assert state.assignment(np.zeros(3, np.int32)).dtype == torch.int64
    v = state.vectors(np.zeros((3, 6), np.float64), device="cpu")
    assert v.dtype == torch.float32 and v.device.type == "cpu"
    with pytest.raises(ValueError):
        state.endpoint_codebook(np.zeros((4, 2)), np.zeros(4))
    with pytest.raises(ValueError):
        state.selector_patterns(np.zeros((2, 15)))
    assert ETC1_INTEN_TABLES.shape == (8, 4)
