"""The UASTC search's line fits in the port (`basis_universal_tpu_torch/
codecs/uastc/encode.py`): `line_fit` (a masked line fit of every subset of
a partition, the kernel `uastc_line_fit` on the card) and `_mode_trial` (a
single-subset single-plane mode trial, `uastc_mode_trial`), on the CPU,
where they run their plain versions.

Two holds, at every channel count C 1..4, subset count S 1..3, number of
weight levels L 2, 4, 8, 16, 32 (weight bits 1..5) and 1 or 2
least-squares steps:
- the plain versions (`line_fit_reference`, `mode_trial_reference`) give,
  bit for bit, the composition the search ran before the two kernels
  (copied below as it was: `_fit_line_masked` per subset, `_mode_trial`),
  on labels with empty subsets, solid blocks (every pixel on one weight:
  a singular least-squares system, which keeps its endpoints) and pixels
  read through a strided view;
- the search's trials through them give the reference's codes and
  weights, every block, and its errors (rtol 1e-5), against the
  reference's trials jitted, as `compressor.compress` runs them (jitted
  alone, the reference's line fit rounds otherwise: XLA fuses it into
  other fused multiply-adds).

Inputs are made from a seed with numpy. Card tests of the kernels against
these plain versions: `tests/test_torch_cuda.py`.
"""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from basis_universal_tpu.codecs.uastc import encode as ref_encode
from basis_universal_tpu_torch.codecs.uastc import encode as port_encode
from basis_universal_tpu_torch.ops import cuda_etc1s as ck
from basis_universal_tpu_torch.ops.xla_order import _fma, _sum

RTOL = 1e-5
WEIGHT_BITS = (1, 2, 3, 4, 5)                       # L = 2, 4, 8, 16, 32
# an endpoint range of a mode with each weight bit count
EP_RANGE = {1: 20, 2: 20, 3: 19, 4: 13, 5: 11}


def _blocks(n, seed):
    """(n, 16, 4) float32 RGBA blocks, whole numbers 0..255: textured
    blocks, then a fifth unstructured, a tenth solid, a tenth two-tone."""
    rng = np.random.default_rng(seed)
    px = rng.integers(0, 256, (n, 1, 4)) + rng.integers(-30, 31, (n, 16, 4))
    k = n // 10
    px[:2 * k] = rng.integers(0, 256, (2 * k, 16, 4))
    px[2 * k:3 * k] = px[2 * k:3 * k, :1]
    two = rng.integers(0, 256, (k, 2, 4))
    px[3 * k:4 * k] = np.where(rng.integers(0, 2, (k, 16, 1)) == 1,
                               two[:, :1], two[:, 1:])
    return np.clip(px, 0, 255).astype(np.float32)


def _labels(n, n_sub, seed):
    """(n, 16) int64 subsets: random, every third block's subsets past 0
    empty, every seventh block's subset 0 empty where there are others."""
    rng = np.random.default_rng(seed)
    lab = rng.integers(0, n_sub, (n, 16))
    lab[::3] = 0
    if n_sub > 1:
        lab[1::7] = rng.integers(1, n_sub, (len(lab[1::7]), 16))
    return torch.as_tensor(lab)


# ---------------------------------------------------------------------------
# the search's line fits before the two kernels, as they were
# ---------------------------------------------------------------------------

def _todays_fit(v, mask, levels, ls_iters):
    cnt = torch.clamp(mask.sum(1, keepdim=True), min=1.0)
    mean = _sum(v * mask[..., None], 1)[:, None] / cnt[..., None]
    c = (v - mean) * mask[..., None]
    d, proj = port_encode.principal_axis_reference(c, 4)
    inside = mask > 0
    pmin = torch.where(inside, proj, 1e9).amin(1, keepdim=True)
    pmax = torch.where(inside, proj, -1e9).amax(1, keepdim=True)
    lo = torch.clamp(_fma(d, pmin, mean[:, 0]), 0, 255)
    hi = torch.clamp(_fma(d, pmax, mean[:, 0]), 0, 255)

    def weights_for(lo, hi):
        rec = port_encode._rec16_fused(lo[:, None, :], hi[:, None, :],
                                       levels[None, :, None])
        e = _sum((v[:, :, None, :] - rec[:, None, :, :]) ** 2, -1)
        return torch.argmin(e, -1), _sum(e.amin(-1) * mask, -1)

    w, err = weights_for(lo, hi)
    for _ in range(ls_iters):
        lo2, hi2 = port_encode.ls_step_reference(levels[w], mask, v, lo, hi)
        w2, err2 = weights_for(lo2, hi2)
        better = err2 < err
        lo = torch.where(better[:, None], lo2, lo)
        hi = torch.where(better[:, None], hi2, hi)
        w = torch.where(better[:, None], w2, w)
        err = torch.minimum(err, err2)
    return lo, hi, w, err


def _todays_trial(px, wb, ep_range, comps, ls_iters):
    enc = port_encode
    b = px.shape[0]
    inv, unq, wlev = enc._mode_consts(wb, ep_range, str(px.device))
    v = enc._la(px) if comps == 2 else px[..., :comps]
    mean = _sum(v, 1)[:, None] / 16.0
    c = v - mean
    axis, proj = enc.principal_axis_reference(c, 6)
    lo_f = _fma(axis, proj.amin(1, keepdim=True), mean[:, 0])
    hi_f = _fma(axis, proj.amax(1, keepdim=True), mean[:, 0])

    def quant_pair(lo_f, hi_f):
        lo_c, hi_c = enc._quant(inv, lo_f), enc._quant(inv, hi_f)
        return lo_c, hi_c, unq[lo_c], unq[hi_c]

    def best_weights(lo_u, hi_u):
        rec = enc._rec16(lo_u[:, None, :] * (64.0 - wlev)[None, :, None]
                         + hi_u[:, None, :] * wlev[None, :, None])
        d = v[:, :, None, :] - rec[:, None, :, :]
        e = _sum(d * d, -1)
        return torch.argmin(e, -1), _sum(e.amin(-1), -1)

    lo_c, hi_c, lo_u, hi_u = quant_pair(lo_f, hi_f)
    w, err = best_weights(lo_u, hi_u)
    for _ in range(ls_iters):
        lo_c2, hi_c2, lo_u2, hi_u2 = quant_pair(
            *enc.ls_step_reference(wlev[w], None, v, lo_f, hi_f))
        w2, err2 = best_weights(lo_u2, hi_u2)
        bc = (err2 < err)[:, None]
        lo_c = torch.where(bc, lo_c2, lo_c)
        hi_c = torch.where(bc, hi_c2, hi_c)
        lo_u = torch.where(bc, lo_u2, lo_u)
        hi_u = torch.where(bc, hi_u2, hi_u)
        w = torch.where(bc, w2, w)
        err = torch.minimum(err, err2)
    if comps == 3:
        err = err + enc._alpha_err(px)
    elif comps == 2:
        wl = wlev[w]
        l_rec = enc._rec16(lo_u[:, 0][:, None] * (64.0 - wl)
                           + hi_u[:, 0][:, None] * wl)
        d_rgb = px[..., :3] - l_rec[..., None]
        a_rec = enc._rec16(lo_u[:, 1][:, None] * (64.0 - wl)
                           + hi_u[:, 1][:, None] * wl)
        d_a = px[..., 3] - a_rec
        err = (d_rgb * d_rgb).sum((1, 2)) + (d_a * d_a).sum(1)
    ep = torch.stack([lo_c, hi_c], -1).reshape(b, comps * 2)
    return err, ep.to(torch.int32), w.to(torch.int32)


@pytest.fixture(scope="module")
def rgba():
    return torch.as_tensor(_blocks(300, 17))


@pytest.mark.parametrize("ls_iters", [1, 2])
@pytest.mark.parametrize("wb", WEIGHT_BITS)
@pytest.mark.parametrize("n_sub", [1, 2, 3])
@pytest.mark.parametrize("n_ch", [1, 2, 3, 4])
def test_line_fit_plain_version_is_the_searchs_fit(n_ch, n_sub, wb,
                                                   ls_iters, rgba):
    """`line_fit` on the CPU (its plain version) gives the endpoints of
    the search's former per-subset `_fit_line_masked`, bit for bit; the
    pixels a strided view (channels 4 - C..3 of the RGBA blocks), empty
    subsets and solid blocks included; no kernel launches on the CPU."""
    v = rgba[..., 4 - n_ch:]
    levels = torch.as_tensor(port_encode._weight_levels(wb))
    label = _labels(v.shape[0], n_sub, 100 * n_ch + 10 * n_sub + wb)
    ck.reset_launch_counts()
    lo, hi = port_encode.line_fit(v, label, n_sub, levels, ls_iters)
    assert not any(ck.LAUNCHES.values())
    assert lo.shape == hi.shape == (v.shape[0], n_sub, n_ch)
    for s in range(n_sub):
        want = _todays_fit(v, (label == s).float(), levels, ls_iters)
        assert torch.equal(lo[:, s], want[0])
        assert torch.equal(hi[:, s], want[1])
    if n_sub == 1:                        # no label: every pixel subset 0
        got = port_encode.line_fit(v, None, 1, levels, ls_iters)
        want = _todays_fit(v, torch.ones(v.shape[:2]), levels, ls_iters)
        assert torch.equal(got[0][:, 0], want[0])
        assert torch.equal(got[1][:, 0], want[1])


@pytest.mark.parametrize("ls_iters", [1, 2])
@pytest.mark.parametrize("wb", WEIGHT_BITS)
@pytest.mark.parametrize("comps", [2, 3, 4])
def test_mode_trial_plain_version_is_the_searchs_trial(comps, wb, ls_iters,
                                                       rgba):
    """`_mode_trial` on the CPU (its plain version) gives the search's
    former trial, bit for bit: errors, endpoint codes and weights, solid
    blocks included."""
    ck.reset_launch_counts()
    got = port_encode._mode_trial(rgba, wb, EP_RANGE[wb], comps, ls_iters)
    assert not any(ck.LAUNCHES.values())
    want = _todays_trial(rgba, wb, EP_RANGE[wb], comps, ls_iters)
    for g, w in zip(got, want):
        assert g.dtype == w.dtype
        assert torch.equal(g, w)


# the search's trials at other weight bits and step counts than its own
# (`tests/test_torch_uastc_encode.py` runs its own): (trial, positional
# arguments after px)
REF_TRIALS = (
    [("_mode_trial", (wb, EP_RANGE[wb], comps, ls))
     for comps in (2, 3, 4) for wb in WEIGHT_BITS for ls in (1, 2)]
    + [("_mode_trial_2subset", (wb, EP_RANGE[wb], comps, 1 + wb % 2))
       for comps in (2, 3, 4) for wb in WEIGHT_BITS]
    + [("_mode_trial_3subset", (2,))]
    + [(fn, (wb, EP_RANGE[wb], 1 + wb % 2)) for wb in (1, 3, 5)
       for fn in ("_mode_trial_dualplane", "_mode_trial_dualplane4",
                  "_mode_trial_dualplane_la")])


@pytest.mark.parametrize("case", REF_TRIALS,
                         ids=[f"{fn}-{'-'.join(map(str, a))}"
                              for fn, a in REF_TRIALS])
def test_trials_match_the_references_jitted_trials(case, rgba):
    """Every trial that runs `line_fit` or `_mode_trial` gives the
    reference's codes, weights and partitions / ccs in every block, and its
    errors within rtol 1e-5, against the reference's trial jitted."""
    fn, args = case
    px = rgba.numpy()
    want = [np.asarray(x) for x in
            jax.jit(lambda x: getattr(ref_encode, fn)(x, *args))(
                jnp.asarray(px))]
    got = [x.numpy() for x in getattr(port_encode, fn)(rgba, *args)]
    assert len(got) == len(want)
    np.testing.assert_allclose(got[0], want[0], rtol=RTOL)
    for g, w in zip(got[1:], want[1:]):
        assert g.dtype == np.int32
        np.testing.assert_array_equal(g, w)
