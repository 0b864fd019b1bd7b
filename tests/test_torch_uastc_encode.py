"""The port's UASTC LDR 4x4 mode search (`basis_universal_tpu_torch/codecs/
uastc/encode.py`) against the reference's, on the CPU, and its copied host
packers (`codecs/uastc/pack.py`) against the reference's.

Inputs are made from a seed with numpy: the 256 blocks of a synthetic RGB
or RGBA texture, plus solid, two-tone and unstructured blocks.

Tolerances: errors rtol 1e-5. Endpoint codes, weights, partitions / ccs,
winner slots and the ETC1 hint (the intensity table of a radius-0 ETC1S
fit, whose scan the port rounds as XLA-CPU does) are equal in every block;
a block that differed would be packed both ways and decoded, and its two
squared errors printed.

The reference runs jitted, as `compressor.compress` runs it (its search
compiled once per effort level, each mode trial once): XLA's compiled code
rounds otherwise than the eager op-by-op run (fused multiply-adds inside
fusions), and the port follows the compiled code.
"""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

import basis_universal_tpu.ops.etc1s_encode  # noqa: F401  (before tracing)
from basis_universal_tpu.codecs.uastc import encode as ref_encode
from basis_universal_tpu.codecs.uastc.decode import decode_rgba
from basis_universal_tpu.ops.etc1 import image_to_blocks
from basis_universal_tpu_torch.codecs.uastc import encode as port_encode
from basis_universal_tpu_torch.codecs.uastc import pack
from basis_universal_tpu_torch.ops import cuda_etc1s as ck
from basis_universal_tpu_torch.ops import etc1s_encode as tops
from basis_universal_tpu_torch.testing.synthetic import synthetic_texture

RTOL = 1e-5


def _blocks(seed, alpha):
    """(328, 16, 4) float32 RGBA blocks; alpha 255 unless `alpha`."""
    img, _ = synthetic_texture(64, 64, seed=seed, alpha=alpha)
    if not alpha:
        img = np.concatenate([img, np.full((64, 64, 1), 255, np.uint8)], -1)
    px = image_to_blocks(img).reshape(-1, 16, 4).astype(np.int64)
    rng = np.random.default_rng(seed)
    solid = np.repeat(rng.integers(0, 256, (24, 1, 4)), 16, axis=1)
    colors = rng.integers(0, 256, (24, 2, 4))
    two_tone = np.where(rng.integers(0, 2, (24, 16, 1)) == 1,
                        colors[:, :1], colors[:, 1:])
    noise = rng.integers(0, 256, (24, 16, 4))
    px = np.concatenate([px, solid, two_tone, noise])
    if not alpha:
        px[..., 3] = 255
    return px.astype(np.float32)


@pytest.fixture(scope="module")
def rgba_blocks():
    return _blocks(7, alpha=True)


def _sse(blocks, px):
    dec = decode_rgba(blocks).reshape(-1, 16, 4).astype(np.float64)
    return ((dec - px) ** 2).sum((1, 2))


def _check_ties(differ, blocks_got, blocks_want, px, what):
    """No block may be coded differently (the squared errors of any that
    are, printed)."""
    n = int(differ.sum())
    print(f"{what}: {n} of {len(px)} blocks coded differently")
    assert n == 0, (f"{what}: squared errors "
                    f"{_sse(blocks_got[differ], px[differ])} vs "
                    f"{_sse(blocks_want[differ], px[differ])}")
    return n


# (id, trial function, positional args after px, keyword args, packer)
def _single(mode, wb, ep_range, comps):
    return lambda out, n: pack._pack_mode(mode, wb, ep_range, comps, out[1],
                                          out[2], np.zeros(n, np.int64))


def _two(mode, wb, ep_range, comps):
    return lambda out, n: pack._pack_mode_2subset(
        mode, wb, ep_range, comps, out[1], out[2], out[3],
        np.zeros(n, np.int64))


def _dual(mode, wb, ep_range, comps):
    return lambda out, n: pack._pack_mode_dualplane(
        mode, wb, ep_range, out[1], out[2], out[3], np.zeros(n, np.int64),
        comps=comps)


TRIALS = [(f"mode{m}", "_mode_trial", (wb, r, c, 1), {}, _single(m, wb, r, c))
          for (m, wb, r, c) in pack.ALL_MODES]
TRIALS += [
    ("mode0-ls2", "_mode_trial", (4, 19, 3, 2), {}, _single(0, 4, 19, 3)),
    ("mode2", "_mode_trial_2subset", (3, 8, 3, 1), {}, _two(2, 3, 8, 3)),
    ("mode4", "_mode_trial_2subset", (2, 12, 3, 1), {}, _two(4, 2, 12, 3)),
    ("mode9", "_mode_trial_2subset", (2, 8, 4, 1), {}, _two(9, 2, 8, 4)),
    ("mode7", "_mode_trial_2subset", (2, 12, 3, 2),
     dict(pattern_list=7, topk=8), _two(7, 2, 12, 3)),
    ("mode16", "_mode_trial_2subset", (2, 20, 2, 1), {}, _two(16, 2, 20, 2)),
    ("mode3", "_mode_trial_3subset", (2,), {},
     lambda out, n: pack._pack_mode_3subset(out[1], out[2], out[3],
                                            np.zeros(n, np.int64))),
    ("mode6", "_mode_trial_dualplane", (2, 18, 1), {}, _dual(6, 2, 18, 3)),
    ("mode11", "_mode_trial_dualplane4", (2, 13, 1), {}, _dual(11, 2, 13, 4)),
    ("mode13", "_mode_trial_dualplane4", (1, 20, 1), {}, _dual(13, 1, 20, 4)),
    ("mode17", "_mode_trial_dualplane_la", (2, 20, 1), {},
     lambda out, n: pack._pack_mode_dualplane(
         17, 2, 20, out[1], out[2], np.ones(n, np.int64),
         np.zeros(n, np.int64), comps=2, emit_ccs=False)),
]


@pytest.mark.parametrize("case", TRIALS, ids=[t[0] for t in TRIALS])
def test_mode_trial_matches_reference(case, rgba_blocks):
    name, fn, args, kw, packer = case
    px = rgba_blocks
    n = px.shape[0]
    trial = jax.jit(lambda x: getattr(ref_encode, fn)(x, *args, **kw))
    want = [np.asarray(x) for x in trial(jnp.asarray(px))]
    got = [x.numpy() for x in
           getattr(port_encode, fn)(torch.from_numpy(px), *args, **kw)]
    assert len(got) == len(want)
    for g, w in zip(got, want):
        assert g.shape == w.shape
    assert all(g.dtype == np.int32 for g in got[1:])
    np.testing.assert_allclose(got[0], want[0], rtol=RTOL)
    differ = np.zeros(n, bool)
    for g, w in zip(got[1:], want[1:]):
        differ |= (g != w).reshape(n, -1).any(1)
    as_np = [[x.astype(np.int64) for x in out] for out in (got, want)]
    _check_ties(differ, packer(as_np[0], n), packer(as_np[1], n), px, name)


def _etc1_hint_err(px, inten):
    """Exact ETC1S error of each block's radius-0 base with table inten."""
    rgb = torch.from_numpy(np.ascontiguousarray(px[..., :3]))
    base5 = torch.clamp(torch.round(rgb.mean(1) * ck.C31_255), 0, 31)
    packed = tops._pack(base5.to(torch.int32),
                        torch.from_numpy(inten.astype(np.int32)))
    return ck.palette_errs_packed_reference(rgb, packed[:, None])[:, 0].numpy()


@pytest.mark.parametrize("alpha", [False, True])
@pytest.mark.parametrize("effort", [0, 2, 3])
def test_search_matches_reference(effort, alpha):
    px = _blocks(11 + effort, alpha)
    modes, ls_iters, extra, topk = pack._effort_mode_set(effort, alpha)
    want = np.asarray(ref_encode._search_device(jnp.asarray(px), modes,
                                                ls_iters, extra, topk=topk))
    got = port_encode._search(torch.from_numpy(px), modes, ls_iters, extra,
                              topk)
    assert got.shape == want.shape == (px.shape[0], 59)
    assert got.dtype == np.uint8

    hint = got[:, 58] != want[:, 58]
    print(f"effort {effort} alpha {alpha}: ETC1 hints differing "
          f"{int(hint.sum())} (exact errors "
          f"{_etc1_hint_err(px[hint], got[hint, 58])} vs "
          f"{_etc1_hint_err(px[hint], want[hint, 58])})")
    assert not hint.any()
    differ = (got != want).any(1)
    _check_ties(differ, pack._pack_from_compact(got, px, modes, extra),
                pack._pack_from_compact(want, px, modes, extra), px,
                f"effort {effort} alpha {alpha} search")


@pytest.mark.parametrize("effort,alpha", [(2, False), (4, True)])
def test_copied_packers_match_reference_bytes(effort, alpha):
    """The port's copies of the packers and of the selector RDO give the
    reference's bytes on the same compact winner buffer."""
    px = _blocks(21, alpha)
    modes, ls_iters, extra, topk = pack._effort_mode_set(effort, alpha)
    assert (modes, ls_iters, extra, topk) == ref_encode._effort_mode_set(
        effort, alpha)
    compact = port_encode._search(torch.from_numpy(px), modes, ls_iters,
                                  extra, topk)
    slots = np.unique(compact[:, 0])
    print(f"effort {effort} alpha {alpha}: {len(slots)} of "
          f"{len(modes) + 1 + len(extra)} mode slots won some block")
    got = pack._pack_from_compact(compact, px, modes, extra)
    want = ref_encode._pack_from_compact(compact, px, modes, extra)
    np.testing.assert_array_equal(got, want)
    for lam, dict_size in ((1.0, 4096), (3.0, 256)):
        np.testing.assert_array_equal(
            pack.rdo_selector_match(got, px, lam, dict_size=dict_size),
            ref_encode.rdo_selector_match(want, px, lam, dict_size=dict_size))
    for ep_range in sorted({m[2] for m in pack.ALL_MODES} | {7, 8, 12, 13, 18}):
        for a, b in zip(pack.quant_luts(ep_range),
                        ref_encode.quant_luts(ep_range)):
            np.testing.assert_array_equal(a, b)


def test_encode_blocks_batch_equals_encode_blocks():
    """The uint8 upload of the batch path gives the float path's blocks."""
    imgs = [_blocks(s, True) for s in (31, 32)]
    batch = list(port_encode.encode_blocks_batch(imgs, effort=1,
                                                 has_alpha=True, device="cpu"))
    assert len(batch) == 2
    for px, ub in zip(imgs, batch):
        np.testing.assert_array_equal(
            ub, port_encode.encode_blocks(px, effort=1, has_alpha=True,
                                          device="cpu"))


def _reference_ls_step(wl, mask, v, lo, hi):
    """One pass of the least-squares loop of the reference's
    `_fit_line_masked` (its body as written there), jitted below."""
    a_k = (64.0 - wl) * (1.0 / 64.0) * mask
    b_k = wl * (1.0 / 64.0) * mask
    A = jnp.sum(a_k * a_k, 1)
    Bm = jnp.sum(a_k * b_k, 1)
    C = jnp.sum(b_k * b_k, 1)
    P = jnp.einsum("bi,bic->bc", a_k, v)
    Q = jnp.einsum("bi,bic->bc", b_k, v)
    det = A * C - Bm * Bm
    ok = jnp.abs(det) > 1e-6
    dd = jnp.where(ok, det, 1.0)
    lo2 = jnp.clip(jnp.where(
        ok[:, None], (C[:, None] * P - Bm[:, None] * Q) / dd[:, None], lo),
        0, 255)
    hi2 = jnp.clip(jnp.where(
        ok[:, None], (A[:, None] * Q - Bm[:, None] * P) / dd[:, None], hi),
        0, 255)
    return lo2, hi2


@pytest.mark.parametrize("masked", [False, True])
@pytest.mark.parametrize("n_ch", [1, 2, 3, 4])
def test_ls_step_plain_version_is_the_references_step(n_ch, masked,
                                                      rgba_blocks):
    """`ls_step_reference` (the least-squares step of the plain line fits)
    gives the bits of the reference's least-squares step, jitted, on every
    block: seeded
    weight levels (a tenth of the blocks with one weight for all pixels, a
    singular system that keeps lo / hi), fallback endpoints out of range
    (clamped), the pixels a strided view of the RGBA blocks."""
    rng = np.random.default_rng(n_ch + 10 * masked)
    px = rgba_blocks
    n = px.shape[0]
    lev = port_encode._weight_levels(2)
    wl = lev[rng.integers(0, len(lev), (n, 16))].astype(np.float32)
    wl[::10] = lev[1]
    mask = ((rng.random((n, 16)) < 0.6) if masked
            else np.ones((n, 16))).astype(np.float32)
    lo = rng.uniform(-5, 260, (n, n_ch)).astype(np.float32)
    hi = rng.uniform(-5, 260, (n, n_ch)).astype(np.float32)
    v = torch.from_numpy(px)[..., :n_ch]
    want = jax.jit(_reference_ls_step)(
        jnp.asarray(wl), jnp.asarray(mask), jnp.asarray(v.numpy()),
        jnp.asarray(lo), jnp.asarray(hi))
    ck.reset_launch_counts()
    got = port_encode.ls_step_reference(
        torch.from_numpy(wl), torch.from_numpy(mask) if masked else None, v,
        torch.from_numpy(lo), torch.from_numpy(hi))
    for g, w in zip(got, want):
        np.testing.assert_array_equal(g.numpy(), np.asarray(w))
    assert not any(ck.LAUNCHES.values())            # the CPU launches nothing


@pytest.mark.parametrize("alpha", [False, True])
def test_search_runs_each_line_fit_as_one_chain_of_each(alpha, rgba_blocks):
    """The effort-2 search calls `_mode_trial` once per single-subset mode
    (4 in an RGB search, 8 with alpha) and `line_fit` once per 2-subset
    candidate and per dual-plane plane (14; 36), each one launch on the
    card (`uastc_mode_trial`, `uastc_line_fit`), and of the generic
    XLA-order operators leaves the counts `chip_smoke.py` asserts per image
    on the card: the two ordered sums of each 2-subset candidate's error
    (16 RGB, 24 RGBA) and no fused multiply-add; the ETC1 hint's scan, a
    kernel on the card, is not counted. The line fits are held to the
    reference's bits inside its jitted mode trials
    (`test_mode_trial_matches_reference`, `test_search_matches_reference`,
    `tests/test_torch_line_fit.py`): jitted alone, the reference's power
    iteration rounds otherwise."""
    from basis_universal_tpu_torch.ops import xla_order as xo

    calls = dict(mode_trial=0, line_fit=0, fma=0, reduce=0, hint=0)
    depth = [0]
    nested = ("mode_trial", "line_fit", "hint")

    def counted(name, fn):
        def run(*args, **kw):
            if not depth[0]:
                calls[name] += 1
            depth[0] += name in nested
            try:
                return fn(*args, **kw)
            finally:
                depth[0] -= name in nested
        return run

    mp = pytest.MonkeyPatch()
    try:
        mp.setattr(port_encode, "_mode_trial",
                   counted("mode_trial", port_encode._mode_trial))
        mp.setattr(port_encode, "line_fit",
                   counted("line_fit", port_encode.line_fit))
        mp.setattr(xo, "fma_reference", counted("fma", xo.fma_reference))
        mp.setattr(xo, "reduce_reference",
                   counted("reduce", xo.reduce_reference))
        mp.setattr(port_encode.etc1s_ops, "encode_blocks",
                   counted("hint", port_encode.etc1s_ops.encode_blocks))
        px = rgba_blocks if alpha else _blocks(7, alpha=False)
        modes, ls_iters, extra, topk = pack._effort_mode_set(2, alpha)
        port_encode._search(torch.from_numpy(px), modes, ls_iters, extra,
                            topk)
    finally:
        mp.undo()
    want = (dict(mode_trial=8, line_fit=36, fma=0, reduce=24, hint=1)
            if alpha else
            dict(mode_trial=4, line_fit=14, fma=0, reduce=16, hint=1))
    assert calls == want
