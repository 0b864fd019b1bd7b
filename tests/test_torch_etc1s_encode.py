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
from basis_universal_tpu_torch.ops import cuda_etc1s as ck
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
@pytest.mark.parametrize("radius", [0, 1, 2])
def test_encode_blocks_output_unchanged_by_the_fused_shortlist(
        radius, perceptual, monkeypatch):
    """encode_blocks shortlists through `factorized_scan_shortlist`; through
    the scan's full errors and a stable sort, as before the fused kernel, it
    gives the same dict on the CPU."""
    px = _t(_blocks(400, 9 + radius))
    got = tops.encode_blocks(px, radius=radius, perceptual=perceptual)

    def unfused(pixels, radius=1, perceptual=False):
        flat = tops.cuda_etc1s.factorized_scan_errors_reference(
            pixels, radius=radius, perceptual=perceptual)
        return tops._shortlist(flat, min(16, flat.shape[1]))

    monkeypatch.setattr(tops.cuda_etc1s, "factorized_scan_shortlist", unfused)
    want = tops.encode_blocks(px, radius=radius, perceptual=perceptual)
    assert got.keys() == want.keys()
    for key in want:
        assert torch.equal(got[key], want[key]), key


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
    np.testing.assert_array_equal(got, want)
    # the port's own draw: seeds that needed a fill are training vectors
    own = tops.bisecting_init(_t(vecs), _t(w), c,
                              generator=torch.Generator().manual_seed(1))
    assert own.shape == (c, 6)
    assert all(np.isclose(vecs, r, rtol=1e-4, atol=1e-6).all(-1).any()
               or np.isclose(want, r, rtol=1e-4, atol=1e-6).all(-1).any()
               for r in own.numpy())


def _bisect_case(kind):
    """(vecs, weights, C) of a bisecting-init case: "texture", image 0's
    endpoint vectors (the reference's encode_blocks of
    synthetic_texture(512, 768, seed=0): one 24,576-row cluster, C 2,416);
    "weighted", weights other than 1; "duplicates", 600 vectors drawn from
    12, so splits leave clusters empty; "n<c", fewer vectors than
    clusters."""
    rng = np.random.default_rng(len(kind))
    if kind == "texture":
        from basis_universal_tpu_torch.testing.synthetic import \
            synthetic_texture
        from basis_universal_tpu_torch.ops.etc1 import image_to_blocks

        img, _ = synthetic_texture(512, 768, seed=0)
        px = image_to_blocks(img).reshape(-1, 16, 3).astype(np.float32)
        enc = jops.encode_blocks(jnp.asarray(px), radius=1)
        vecs = np.concatenate([np.asarray(enc["low"]),
                               np.asarray(enc["high"])], -1) / 255.0
        vecs = vecs.astype(np.float32)
        return vecs, np.ones(len(vecs), np.float32), 2416
    if kind == "weighted":
        return (rng.uniform(0, 1, (500, 6)).astype(np.float32),
                rng.uniform(0.25, 4.0, 500).astype(np.float32), 40)
    if kind == "duplicates":
        pool = rng.integers(0, 32, (12, 6)) / 31.0
        return (pool[rng.integers(0, 12, 600)].astype(np.float32),
                np.ones(600, np.float32), 128)
    return rng.uniform(0, 1, (100, 6)).astype(np.float32), np.ones(
        100, np.float32), 256


@pytest.mark.parametrize("kind", ["texture", "weighted", "duplicates", "n<c"])
def test_bisecting_init_cases(kind):
    """The seeds of the JAX `bisecting_init`, bit for bit: the main path's
    one 24,576-row cluster, weights other than 1, splits that leave
    clusters empty and fewer vectors than clusters (random fill)."""
    vecs, w, c = _bisect_case(kind)
    key = jax.random.PRNGKey(3)
    want = np.asarray(jops.bisecting_init(jnp.asarray(vecs), jnp.asarray(w),
                                          c, key))
    fill = np.asarray(jax.random.choice(key, jnp.asarray(vecs), (c,)))
    got = tops.bisecting_init(_t(vecs), _t(w), c, fill=state.vectors(fill))
    np.testing.assert_array_equal(got.numpy(), want)
    leaves = tops.bisect_leaves(_t(vecs), _t(w), c)
    if kind in ("duplicates", "n<c", "texture"):
        assert int((leaves[:, 0] == 0).sum()) > 0       # empty clusters


def _todays_round(vecs, w, assign, c_max):
    """One round of the bisecting init as the port composed it before its
    round kernel: segment sums by cluster id over the rows in row order."""
    from basis_universal_tpu_torch.ops.xla_order import _dot, _fma, _sum

    n, f = vecs.shape
    outer = (vecs[:, :, None] * vecs[:, None, :]).reshape(n, f * f)
    feats = torch.cat([w[:, None], vecs * w[:, None], outer * w[:, None]], -1)
    m = tops.segment_sum(feats, assign, c_max)
    cnt = m[:, 0]
    mean = m[:, 1:1 + f] / torch.clamp(cnt, min=1e-9)[:, None]
    m2 = m[:, 1 + f:].reshape(c_max, f, f)
    cov = _fma(-(cnt[:, None, None] * mean[:, :, None]), mean[:, None, :], m2)
    axis = ck.bisect_power_axis(cov)
    thr = _sum(mean * axis, -1)
    ga = torch.cat([axis, thr[:, None]], -1)[assign]
    proj = _dot(vecs, ga[:, :f]) - ga[:, f]
    return assign * 2 + (proj > 0).to(torch.int64), feats


@pytest.mark.parametrize("kind", ["weighted", "duplicates", "n<c"])
def test_bisect_round_plain_is_todays_composition(kind):
    """Each round's plain version (`bisect_round_reference`, on member rows
    kept in cluster and row order) against the composition by cluster ids:
    the same members in each child, in row order, the same offsets, and
    the same leaf counts and means, bit for bit; the moment columns equal
    the composition's features."""
    vecs, w, c = _bisect_case(kind)
    tv, tw = _t(vecs), _t(w)
    rounds = max(1, int(np.ceil(np.log2(c))))
    c_max = 1 << rounds
    assign = torch.zeros(len(vecs), dtype=torch.int64)
    members, starts = ck.bisect_rows(tv, tw)
    first = members
    for r in range(rounds):
        assign, feats = _todays_round(tv, tw, assign, c_max)
        members, starts, leaves = ck.bisect_round(members, starts,
                                                  last=r == rounds - 1)
        order = torch.sort(assign, stable=True).indices
        np.testing.assert_array_equal(members[:, :6].numpy(),
                                      tv[order].numpy())
        np.testing.assert_array_equal(members[:, 6].numpy(),
                                      tw[order].numpy())
        counts = torch.bincount(assign, minlength=2 << r)
        np.testing.assert_array_equal((starts[1:] - starts[:-1]).numpy(),
                                      counts[:2 << r].numpy())
    np.testing.assert_array_equal(ck.bisect_moments(first).numpy(),
                                  feats.numpy())
    m = tops.segment_sum(feats[:, :7], assign, c_max)
    want = torch.cat([m[:, :1], m[:, 1:] / torch.clamp(m[:, :1], min=1e-9)],
                     1)
    np.testing.assert_array_equal(leaves.numpy(), want.numpy())


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
    if not perceptual:
        # the shortlist orders the duplicate's tie as approx_min_k does
        assert differ.sum() == 0


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


@pytest.mark.parametrize("perceptual", [False, True])
@pytest.mark.parametrize("radius", [0, 1, 2])
def test_cluster_scan_is_the_references_formulation(radius, perceptual):
    """The per-block gray-axis sums against the cluster base (the full
    scan's columns) equal the reference's `_gray_axis_minterm` of its
    XLA branch, and the assembled (C, D*8) cluster errors
    (`cluster_scan_assemble`) the reference's `flat` of
    `optimize_cluster_endpoints` (jitted as the frontend runs it), with
    whole-numbered pixels: bit for bit in RGB; with the perceptual metric
    (the bases and pixels transformed, the cluster levels lb given; a
    fragment jitted alone fuses otherwise than the whole frontend, whose
    roundings the port keeps) the gray-axis sums and the errors within rtol
    1e-5, the errors' of |constant part| + |error|."""

    rng = np.random.default_rng(30 + radius)
    px = _blocks(500, 31 + radius)
    c = 37
    ids = rng.integers(0, c, 500).astype(np.int32)
    base5 = rng.integers(0, 32, (c, 3)).astype(np.int32)
    deltas = jops._candidate_deltas(radius)
    d_n = len(deltas)
    gvec = jnp.asarray(jops.PERC_P @ np.ones(3, np.float32))

    @jax.jit
    def ref(px, ids, base5):
        c5s = jnp.clip(base5[None] + jnp.asarray(deltas)[:, None, :], 0, 31)
        base8 = jops.expand5(c5s).astype(jnp.float32)           # (D,C,3)
        if perceptual:
            base8 = jops.perceptual_transform(base8)
            px = jops.perceptual_transform(px)
        mom = jops._block_moments(px, gvec if perceptual else None)
        seg = lambda x: jax.ops.segment_sum(x, ids, num_segments=c)
        npix = 16.0 * seg(jnp.ones(px.shape[0], jnp.float32))
        lb = base8 @ gvec if perceptual else jnp.sum(base8, axis=-1)
        q = (seg(mom["sum_x2"])[None]
             - 2.0 * jnp.einsum("dcx,cx->dc", base8, seg(mom["sum_x"]))
             + npix[None] * jnp.sum(base8 * base8, axis=-1))
        su2 = (seg(mom["sum_l2"])[None] - 2.0 * lb * seg(mom["sum_l"])[None]
               + npix[None] * lb * lb)
        u = (mom["luma"][None] - lb[:, ids][..., None]) * (1.0 / 3.0)
        mt = jnp.moveaxis(jops._gray_axis_minterm(u), 0, 1).reshape(-1, d_n * 8)
        errs = (q - su2 * (1.0 / 3.0)).T[:, :, None] \
            + 3.0 * seg(mt).reshape(c, d_n, 8)
        return mt, errs.reshape(c, -1), q - su2 * (1.0 / 3.0)

    want_mt, want_flat, want_cst = (np.asarray(x) for x in ref(
        jnp.asarray(px), jnp.asarray(ids), jnp.asarray(base5)))
    t_ids = torch.from_numpy(ids).long()
    t_base5 = torch.from_numpy(base5)
    base8 = tops.expand5(torch.clamp(
        t_base5[None] + torch.as_tensor(deltas)[:, None, :], 0, 31)).float()
    lb = None
    if perceptual:
        base8 = tops.perceptual_transform(base8)
        lb = tops._dot(base8, torch.as_tensor(tops.GVEC))
    mt = ck.factorized_scan(_t(px), base5=t_base5[t_ids].float().contiguous(),
                            radius=radius, perceptual=perceptual,
                            lb=None if lb is None else
                            lb[:, t_ids].T.contiguous())
    ck.reset_launch_counts()
    flat = tops._cluster_scan(_t(px), t_ids, base8, lb, mt, perceptual)
    assert ck.LAUNCHES == dict.fromkeys(ck.LAUNCHES, 0)
    if not perceptual:
        np.testing.assert_array_equal(mt.numpy(), want_mt)
        np.testing.assert_array_equal(flat.numpy(), want_flat)
        return
    mag = np.abs(want_cst).T[:, :, None] + np.abs(want_flat).reshape(
        c, d_n, 8)
    np.testing.assert_allclose(mt.numpy(), want_mt, rtol=RTOL, atol=1e-3)
    err = np.abs(flat.numpy().reshape(c, d_n, 8)
                 - want_flat.reshape(c, d_n, 8))
    assert (err <= RTOL * mag + 1e-3).all()


@pytest.mark.parametrize("c", [24, 64, 65, 96, 97, 1000, 2400, 2416])
def test_cross6_order_is_this_hosts_xla_dot(c):
    """`xla_order._cross6` names XLA-CPU's summation order of a 6-long
    contraction by C alone (two interleaved chains where C mod 64 is 1..32,
    one chain otherwise): held bit for bit against `jax.jit(jnp.dot)` on
    the host that runs the test, on both sides of the rule, so a host whose
    XLA tiles its products otherwise fails here and not deep in a
    codebook."""
    from basis_universal_tpu_torch.ops.xla_order import _cross6

    rng = np.random.default_rng(c)
    a = rng.uniform(0, 1, (512, 6)).astype(np.float32)
    b = rng.uniform(0, 1, (c, 6)).astype(np.float32)
    want = np.asarray(jax.jit(lambda x, y: x @ y.T)(a, b))
    np.testing.assert_array_equal(_cross6(_t(a), _t(b)).numpy(), want)


@pytest.mark.parametrize("c", [97, 2416])
def test_cross6_argmin_and_distances_are_the_references(c):
    """The k-means assignment (`cross6_argmin`, bf16-rounded operands at >=
    1024 clusters) equals the reference's jitted formulation bit for bit,
    first index on ties (a duplicated centroid planted); the refine through
    `cross6_distances` picks the reference's cluster for every block
    (distinct codebook entries, so no two candidates tie); the CPU
    launches nothing."""
    from basis_universal_tpu_torch.ops import cuda_etc1s as ck

    rng = np.random.default_rng(c + 1)
    vecs = rng.uniform(0, 1, (3000, 6)).astype(np.float32)
    cents = vecs[rng.choice(3000, c, replace=False)].copy()
    cents[c // 2] = cents[c // 3]                    # an exact tie
    dt = jnp.bfloat16 if c >= 1024 else jnp.float32

    @jax.jit
    def ref_assign(v, cb):
        cross = jax.lax.dot_general(v.astype(dt), cb.astype(dt).T,
                                    (((1,), (0,)), ((), ())),
                                    preferred_element_type=jnp.float32)
        return jnp.argmin(jnp.sum(cb * cb, -1)[None, :] - 2.0 * cross, -1)

    ck.reset_launch_counts()
    got = tops.kmeans_assign(_t(vecs), _t(cents), c)
    np.testing.assert_array_equal(got.numpy(),
                                  np.asarray(ref_assign(vecs, cents)))

    px = _blocks(500, c)
    enc = jops.encode_blocks(jnp.asarray(px), radius=1)
    vec6 = np.concatenate([np.asarray(enc["low"]), np.asarray(enc["high"])],
                          -1) / 255.0
    code = rng.choice(32 ** 3 * 8, c, replace=False)
    c5 = np.stack([code & 31, (code >> 5) & 31, (code >> 10) & 31],
                  -1).astype(np.int32)
    it = (code >> 15).astype(np.int32)
    pal = etc1s_palette(c5, it).astype(np.float32)
    cb6 = np.concatenate([pal[:, 0], pal[:, 3]], -1) / 255.0
    g5, gi = state.endpoint_codebook(c5, it)
    ga, _ = tops.refine_endpoint_assignment(
        _t(px), state.vectors(vec6), state.vectors(cb6), g5, gi, topk=8)
    wa, _ = jops.refine_endpoint_assignment(
        jnp.asarray(px), jnp.asarray(vec6, jnp.float32), jnp.asarray(cb6),
        jnp.asarray(c5), jnp.asarray(it), topk=8)
    np.testing.assert_array_equal(ga.numpy(), np.asarray(wa))

    # the distances with their norms inside: the norms as the caller
    # computed them before (`_dot`, a fused multiply-add chain)
    from basis_universal_tpu_torch.ops.xla_order import _cross6, _dot

    tv, tc = _t(vecs), _t(cents)
    np.testing.assert_array_equal(
        ck.cross6_distances(tv, tc).numpy(),
        ((_dot(tv, tv)[:, None] - 2.0 * _cross6(tv, tc))
         + _dot(tc, tc)[None, :]).numpy())
    assert ck.LAUNCHES == dict.fromkeys(ck.LAUNCHES, 0)
    with pytest.raises(ValueError):
        ck.cross6_argmin(tv[:, :5].contiguous(), tc)
    with pytest.raises(ValueError):
        ck.cross6_distances(tv, tc[:0])
    with pytest.raises(TypeError):
        ck.cross6_argmin(tv.double(), tc)


def _tied_rows(n, levels, seed, zeros=False):
    """256 rows of n whole-numbered distances over `levels` values (ties
    everywhere when levels is small); with `zeros`, values in -2..2 whose
    zeros are -0.0 or +0.0 at random (equal to the comparator)."""
    rng = np.random.default_rng(seed)
    if zeros:
        d = rng.integers(-2, 3, (256, n)).astype(np.float32)
        z = d == 0
        d[z] = np.where(rng.random(z.sum()) < 0.5, -0.0, 0.0)
        return d
    return rng.integers(0, levels, (256, n)).astype(np.float32)


_AMK = jax.jit(lambda d, k: jax.lax.approx_min_k(d, k)[1], static_argnums=1)


@pytest.mark.parametrize("n,levels,zeros", [
    (17, 2, False), (17, 5, False), (17, 40, False), (17, 3, True),
    (2416, 3, False), (2416, 40, False), (2416, 2000, False),
    (2416, 3, True)])
def test_host_sort_is_approx_min_k(n, levels, zeros):
    """The host sort (`xla_cpu_min_k_reference`: `std::sort` of the whole
    row, and the card kernel's introsort pruned to the first k places) and
    the refine shortlist built on it give the columns of the reference's
    jitted `jax.lax.approx_min_k` in its order on every row, where a stable
    sort orders the ties otherwise."""
    d = _tied_rows(n, levels, seed=n + levels, zeros=zeros)
    for k in (2, 16):
        want = np.asarray(_AMK(jnp.asarray(d), k))
        full = ck.xla_cpu_min_k_reference(_t(d), k, mode="std_sort").numpy()
        pruned = ck.xla_cpu_min_k_reference(_t(d), k).numpy()
        np.testing.assert_array_equal(full, want)
        np.testing.assert_array_equal(pruned, want)
        np.testing.assert_array_equal(
            tops._refine_shortlist(_t(d), k).numpy(), want)
    stable = tops._shortlist(_t(d), 16).numpy()
    print(f"n {n} levels {levels} zeros {zeros}: the stable sort agrees on "
          f"{(stable == want).all(1).sum()} of 256 rows")


def test_refine_shortlist_sends_only_rows_with_ties_to_the_host():
    """Every row goes through the one sort now (on the card, its kernel),
    and rows whose k + 1 smallest distances are all different get the
    stable sort's columns from it (the only order there is); rows with a
    tie there get `approx_min_k`'s. Bad sizes raise."""
    rng = np.random.default_rng(3)
    d = rng.permutation(np.arange(300 * 40, dtype=np.float32)).reshape(300, 40)
    tied = np.arange(0, 300, 7)
    d[tied, 1:4] = d[tied].min(1)[:, None]      # ties among the 17 smallest
    d[::5, -1] = -1.0
    d[::5, -2] = -1.0                           # a tie at the very front
    got = tops._refine_shortlist(_t(d), 16).numpy()
    flagged = np.zeros(300, bool)
    flagged[tied] = flagged[::5] = True
    stable = tops._shortlist(_t(d), 16).numpy()
    np.testing.assert_array_equal(got[~flagged], stable[~flagged])
    np.testing.assert_array_equal(got, np.asarray(_AMK(jnp.asarray(d), 16)))
    np.testing.assert_array_equal(
        tops._refine_shortlist(_t(d[:, :1].copy()), 16).numpy(),
        np.zeros((300, 1)))
    for k in (1, 41):
        with pytest.raises(ValueError):
            ck.xla_cpu_min_k(_t(d), k)
    with pytest.raises(ValueError):
        ck.xla_cpu_min_k_reference(_t(d[:, :4]), 5)


@pytest.mark.parametrize("n,levels", [(2, 2), (17, 3), (40, 2), (100, 5),
                                      (2416, 3), (2416, 2000)])
def test_host_sort_heap_is_libstdcxx_partial_sort(n, levels):
    """The introsort's fallback where its depth limit runs out, the heap of
    `csrc/xla_cpu_sort.h` (which the card kernel runs too), orders a whole
    tie-heavy row as libstdc++'s `std::partial_sort(first, last, last)`."""
    d = _tied_rows(n, levels, seed=7 * n + levels)
    np.testing.assert_array_equal(
        ck.xla_cpu_min_k_reference(_t(d), n, mode="heap").numpy(),
        ck.xla_cpu_min_k_reference(_t(d), n, mode="std_partial_sort").numpy())
    z = _tied_rows(n, levels, seed=n, zeros=True)
    np.testing.assert_array_equal(
        ck.xla_cpu_min_k_reference(_t(z), n, mode="heap").numpy(),
        ck.xla_cpu_min_k_reference(_t(z), n, mode="std_partial_sort").numpy())
    # a depth limit of 0 sends the introsort to the heap at once
    k = min(n, 16)
    np.testing.assert_array_equal(
        ck.xla_cpu_min_k(_t(d), k, depth_cap=0).numpy(),
        ck.xla_cpu_min_k_reference(_t(d), n, mode="heap").numpy()[:, :k])


@pytest.mark.parametrize("n,levels,zeros", [
    (n, levels, False) for n in (17, 2416, 9000) for levels in (2, 3, 40, 2000)]
    + [(n, 3, True) for n in (17, 2416, 9000)])
def test_host_sort_pairs_is_std_sort(n, levels, zeros):
    """The card's algorithm run sequentially (`xla_cpu_min_k_reference`
    mode "pairs": each Hoare partition as its swap pairs from 32-entry
    chunk masks, the final insertion sort as stable ranks) gives the
    columns of `std::sort` for every k up to 32 and of the jitted
    `jax.lax.approx_min_k`, on tie-heavy rows (signed zeros included); with
    a depth limit of 0, 1 and 3 those of the introsort run step for step
    (mode "pruned"), at 0 the heap fallback's."""
    d = _tied_rows(n, levels, seed=3 * n + levels, zeros=zeros)
    full = ck.xla_cpu_min_k_reference(_t(d), min(n, 32), mode="std_sort")
    for k in range(1, min(n, 32) + 1):
        np.testing.assert_array_equal(
            ck.xla_cpu_min_k_reference(_t(d), k, mode="pairs").numpy(),
            full[:, :k].numpy())
    for k in (2, 16, 32):
        if k <= n:
            np.testing.assert_array_equal(full[:, :k].numpy(),
                                          np.asarray(_AMK(jnp.asarray(d), k)))
    for cap in (0, 1, 3):
        for k in (2, 16):
            np.testing.assert_array_equal(
                ck.xla_cpu_min_k_reference(_t(d), k, mode="pairs",
                                           depth_cap=cap).numpy(),
                ck.xla_cpu_min_k_reference(_t(d), k,
                                           depth_cap=cap).numpy())
    np.testing.assert_array_equal(
        ck.xla_cpu_min_k_reference(_t(d), 16, mode="pairs",
                                   depth_cap=0).numpy(),
        ck.xla_cpu_min_k_reference(_t(d), n, mode="heap").numpy()[:, :16])


@pytest.mark.parametrize("n,levels,zeros", [
    (2, 2, False), (16, 3, False), (17, 3, False), (40, 2, False),
    (100, 5, True), (2416, 3, False), (2416, 2000, False), (2416, 3, True)])
def test_final_insertion_sort_is_a_stable_sort(n, levels, zeros):
    """libstdc++'s final insertion sort (`xla_cpu_sort.h`, mode
    "final_insertion"), over a range whose least value lies in its first
    16 places as the introsort leaves it, is the stable sort of the range
    by value, -0.0 equal to +0.0: what the card's final step (stable
    ranks) computes in its place. A row that breaks the condition is
    refused."""
    d = _tied_rows(n, levels, seed=11 * n + levels, zeros=zeros)
    rng = np.random.default_rng(n)
    d[np.arange(256), rng.integers(0, min(n, 16), 256)] = d.min()
    got = ck.xla_cpu_min_k_reference(_t(d), n, mode="final_insertion")
    np.testing.assert_array_equal(got.numpy(),
                                  np.argsort(d, axis=1, kind="stable"))
    if n > 16:
        bad = np.zeros((1, n), np.float32)
        bad[0, -1] = -1.0
        with pytest.raises(ValueError):
            ck.xla_cpu_min_k_reference(_t(bad), n, mode="final_insertion")


@pytest.mark.parametrize("c", [17, 64, 65, 100, 600])
def test_refine_shortlist_is_the_references_d6_and_approx_min_k(c):
    """The refine's shortlist as the port takes it, `cross6_distances` then
    `_refine_shortlist` (on the card their two kernels), gives the
    reference's own `d6` (`refine_endpoint_assignment`) and the columns of
    its jitted `approx_min_k`, with whole-numbered centroid components so
    that rows tie, at C on both sides of the C mod 64 rule, k 2 to 32."""
    rng = np.random.default_rng(c)
    a = rng.integers(0, 4, (300, 6)).astype(np.float32) / 4.0
    cb = rng.integers(0, 3, (c, 6)).astype(np.float32) / 4.0
    d6 = ck.cross6_distances(_t(a), _t(cb))
    ja, jc = jnp.asarray(a), jnp.asarray(cb)
    want = (jnp.sum(ja * ja, -1, keepdims=True) - 2.0 * ja @ jc.T
            + jnp.sum(jc * jc, -1)[None, :])
    np.testing.assert_array_equal(d6.numpy(), np.asarray(want))
    for k in (2, 16, 32):
        if k <= c:
            np.testing.assert_array_equal(
                tops._refine_shortlist(d6, k).numpy(),
                np.asarray(_AMK(want, k)))
    assert ck.LAUNCHES["xla_cpu_min_k"] == 0


@pytest.mark.parametrize("m", [1, 7, 8, 17, 20, 28, 36, 100, 2112, 27 * 525,
                               65536])
def test_perceptual_transform_is_this_hosts_xla_product(m):
    """`perceptual_transform` rounds as the reference's jitted product with
    the constant P^T on the host that runs the test (whole 8-row blocks
    and the trailing M mod 8 rows in their two orders), bit for bit."""
    x = np.random.default_rng(m).uniform(-300, 300, (m, 3)).astype(np.float32)
    x[: m // 2] = np.round(x[: m // 2])
    want = np.asarray(jax.jit(jops.perceptual_transform)(x))
    np.testing.assert_array_equal(tops.perceptual_transform(_t(x)).numpy(),
                                  want)


def test_perceptual_moments_are_the_references():
    """The perceptual block moments (luma, its sum and sum of squares, the
    channel sums, the 48-term sum of squares) are the reference's jitted
    `_block_moments` of the transformed pixels, bit for bit."""
    px = _blocks(600, 12)
    g = jnp.asarray(tops.GVEC)
    want = jax.jit(lambda p: jops._block_moments(
        jops.perceptual_transform(p), g))(jnp.asarray(px))
    got = tops._block_moments(tops.perceptual_transform(_t(px)),
                              torch.as_tensor(tops.GVEC))
    for k in want:
        np.testing.assert_array_equal(got[k].numpy(), np.asarray(want[k]), k)


@pytest.mark.parametrize("c", [60, 61])
def test_perceptual_rescore_is_the_references(c):
    """`palette_errs_packed` (its plain version) with the perceptual metric
    is the reference's XLA rescore bit for bit: against the refine's form
    (the (C, 4, 3) codebook palettes transformed, then gathered by the
    shortlist; with C odd the last palette is flagged as the transform's
    trailing rows) and the per-block form of encode_blocks."""
    from basis_universal_tpu_torch.ops import cuda_etc1s as ck

    rng = np.random.default_rng(c)
    px = _blocks(300, c)
    c5 = rng.integers(0, 32, (c, 3)).astype(np.int32)
    it = rng.integers(0, 8, c).astype(np.int32)
    cand = rng.integers(0, c, (300, 16))
    cand[:, 0] = c - 1                           # the last palette, always

    @jax.jit
    def ref(px, c5, it, cand):
        pal = jnp.clip(jops.expand5(c5).astype(jnp.float32)[:, None, :]
                       + jops._INTEN[it][:, :, None], 0.0, 255.0)
        return jops._palette_errs(jops.perceptual_transform(px),
                                  jops.perceptual_transform(pal)[cand])

    want = np.asarray(ref(jnp.asarray(px), jnp.asarray(c5), jnp.asarray(it),
                          jnp.asarray(cand)))
    ptab = tops._pack(_t(c5), _t(it))
    if c % 2:
        ptab[-1] |= tops.PERC_TAIL_BIT
    got = ck.palette_errs_packed(_t(px), ptab[_t(cand)].contiguous(),
                                 perceptual=True)
    np.testing.assert_array_equal(got.numpy(), want)

    # encode_blocks' form: (B, K, 4, 3) palettes, 64 B rows, transformed
    # as they are
    @jax.jit
    def ref_blocks(px, pal):
        return jops._palette_errs(jops.perceptual_transform(px),
                                  jops.perceptual_transform(pal))

    pk = tops._pack(_t(c5[cand]), _t(it[cand]))
    c5b, itb = tops._unpack(pk)
    pal = np.clip(np.asarray(etc1s_palette(c5b.numpy().reshape(-1, 3),
                                           itb.numpy().reshape(-1)),
                             np.float32).reshape(300, 16, 4, 3), 0, 255)
    np.testing.assert_array_equal(
        ck.palette_errs_packed(_t(px), pk, perceptual=True).numpy(),
        np.asarray(ref_blocks(jnp.asarray(px), jnp.asarray(pal))))


@pytest.mark.parametrize("h,w", [(64, 64), (128, 192)])
def test_etc1s_orders_xla_sums_outside_kernels_once(h, w):
    """One ETC1S encode (q128, effort 1) makes one ordered sum outside the
    hand-written kernels' plain versions (the selector distances' dot) and
    no fused multiply-add: the cluster scan's assembly and the k-means and
    refine norms are inside `cluster_scan_assemble` and the `cross6_*`
    kernels. On the card each such call is one `xla_reduce` / `xla_fma`
    launch (`chip_smoke.EXPECTED_ETC1S_XLA`)."""
    from basis_universal_tpu_torch import compressor
    from basis_universal_tpu_torch.ops import xla_order as xo
    from basis_universal_tpu_torch.testing.synthetic import synthetic_texture

    calls, depth = dict(fma=0, reduce=0), [0]

    def counted(name, fn):
        def run(*args, **kw):
            if name in calls and not depth[0]:
                calls[name] += 1
            depth[0] += 1
            try:
                return fn(*args, **kw)
            finally:
                depth[0] -= 1
        return run

    mp = pytest.MonkeyPatch()
    try:
        mp.setattr(xo, "fma_reference", counted("fma", xo.fma_reference))
        mp.setattr(xo, "reduce_reference",
                   counted("reduce", xo.reduce_reference))
        for name in dir(ck):
            if name.endswith("_reference"):
                mp.setattr(ck, name, counted(name, getattr(ck, name)))
        img, _ = synthetic_texture(h, w, seed=0)
        compressor.compress(img, compressor.CompressorParams(
            quality_level=128, effort=1, device="cpu"))
    finally:
        mp.undo()
    assert calls == dict(fma=0, reduce=1)


@pytest.mark.parametrize("effort", [1, 2])
def test_refine_pass_sorts_the_assignment_once(effort):
    """Each refine pass builds one `segment_order` of the assignment and
    every sum of the pass reads it: the clusters' counts and means, the
    cluster scan and the rescore's cluster errors build none of their own
    (effort 1: one pass, effort 2: two). `optimize_cluster_endpoints` gives
    the same codebook with the shared order as with its own."""
    import sys

    from basis_universal_tpu_torch import compressor
    from basis_universal_tpu_torch.testing.synthetic import synthetic_texture

    callers, plain = [], tops.segment_order

    def counted(ids, num):
        callers.append(sys._getframe(1).f_code.co_name)
        return plain(ids, num)

    mp = pytest.MonkeyPatch()
    try:
        mp.setattr(tops, "segment_order", counted)
        img, _ = synthetic_texture(64, 64, seed=effort)
        compressor.compress(img, compressor.CompressorParams(
            quality_level=128, effort=effort, device="cpu"))
    finally:
        mp.undo()
    assert callers.count("_frontend_impl") == effort
    assert not {"optimize_cluster_endpoints", "_cluster_scan"} & set(callers)
    assert set(callers) == {"_frontend_impl", "segment_sum"}

    rng = np.random.default_rng(8)
    px = _blocks(400, 9)
    ids = torch.from_numpy(rng.integers(0, 30, 400))
    means = _t(rng.uniform(0, 255, (33, 3)).astype(np.float32))
    for perceptual in (False, True):
        shared = tops.optimize_cluster_endpoints(
            _t(px), ids, means, 33, perceptual=perceptual,
            order=tops.segment_order(ids, 33))
        own = tops.optimize_cluster_endpoints(_t(px), ids, means, 33,
                                              perceptual=perceptual)
        assert all(torch.equal(a, b) for a, b in zip(shared, own))
