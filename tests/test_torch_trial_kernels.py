"""The UASTC search's hand-written kernels (`basis_universal_tpu_torch/
csrc/xla_order_kernels.cu`: `uastc_subset_trial`, `uastc_dualplane_trial`,
`uastc_line_fit`, `uastc_mode_trial`) run on the CPU, bit for bit against
their plain versions.

The kernels' own source is compiled here with g++ against
`tests/cuda_host_stub.h`: each CUDA thread a fiber on one host thread,
`__syncwarp` a barrier of the warp's 32 threads, a shuffle or a ballot a
write, a barrier and a read, the rounded intrinsics (`__fadd_rn`,
`__fmaf_rn`, ...) plain float operations under `-ffp-contract=off`. Their wrappers in
`codecs/uastc/encode.py` take the card path (shape checks, one counted
launch) for a CPU tensor that says it is a CUDA one, and launch that build.

Inputs, made from a seed with numpy: 403 blocks (a ragged last CTA of 3
blocks), textured, unstructured, solid (a singular least-squares system)
and two-tone, with random alpha; every instance of each kernel, at weight
bits 1..5 and the top-k of the searches; for the trials also patterns with
a one-pixel and an empty subset and a masked pixel 0 whose centred value
is -0, candidates and channel choices that tie, block counts of 1 to 8,500
(one to eight blocks a warp), strided pixels and LA's fractional chains;
for the single-subset trial every mode of the search at 1 and 2
least-squares steps, 1, 33 and 1,001 blocks, strided, planar and
unaligned pixels, blocks of zero or rank-one covariance and level searches
that tie, and launch shapes of 1 to 16 blocks a warp and 1 to 4 warps a
CTA through its measurement entry, whose per-step stops are held too.
Tolerance: none, every output equal (`torch.equal`). Card tests of the
same kernels: `tests/test_torch_cuda.py`.
"""

import ctypes
import pathlib
import re
import subprocess

import numpy as np
import pytest
import torch

from basis_universal_tpu_torch.codecs.uastc import encode as uenc
from basis_universal_tpu_torch.codecs.uastc import pack
from basis_universal_tpu_torch.ops import _build, xla_order
from basis_universal_tpu_torch.ops import cuda_etc1s as ck

TESTS = pathlib.Path(__file__).resolve().parent
KERNEL = TESTS.parent / "basis_universal_tpu_torch" / "csrc" / \
    "xla_order_kernels.cu"
N_BLOCKS = 403
# a launch `kernel<T...><<<grid, block, shared bytes, stream>>>(`, each
# argument at most one level of parentheses deep
_ARG = r"\s*((?:[^,()]|\([^()]*\))+),"
_LAUNCH = re.compile(r"(\w+(?:<[^<>;]*>)?)<<<" + 3 * _ARG + r"\s*\w+>>>\(")
# dynamic shared memory `extern __shared__ __align__(16) T name[];`
_DYN_SMEM = re.compile(r"extern __shared__ (?:__align__\(\d+\) )?(\w+) "
                       r"(\w+)\[\];")


@pytest.fixture(scope="module")
def host_lib(tmp_path_factory):
    """`csrc/xla_order_kernels.cu` built for the host against
    `cuda_host_stub.h`, its C entries declared as `_build` declares the
    card library's."""
    src = KERNEL.read_text().replace(
        "#include <cuda_runtime.h>", f'#include "{TESTS / "cuda_host_stub.h"}"')
    n_launch = src.count("<<<")
    src, n = _LAUNCH.subn(r"emu_launch_smem(\1, \2, \3, \4, ", src)
    assert n == n_launch
    src = _DYN_SMEM.sub(r"\1* \2 = reinterpret_cast<\1*>(emu_dyn_smem);",
                        src)
    out = tmp_path_factory.mktemp("xla_order_host")
    (out / "kernels.cpp").write_text(src)
    subprocess.run(["g++", "-std=c++20", "-O1", "-ffp-contract=off",
                    "-shared", "-fPIC", "-o",
                    str(out / "kernels.so"), str(out / "kernels.cpp")],
                   check=True)
    return _build._declare_xla_order(ctypes.CDLL(str(out / "kernels.so")))


class _Card(torch.Tensor):
    """A CPU tensor that the wrappers take for a card tensor."""

    @property
    def is_cuda(self):
        return True


@pytest.fixture(scope="module", autouse=True)
def one_torch_thread():
    """The plain versions on one thread: beside the other test workers a
    pool of spinning threads per worker slowed this file 50-fold."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


@pytest.fixture
def on_host(host_lib, monkeypatch):
    """The wrappers' launches go to the host build."""
    def launch(kernel, idx, *args):
        return getattr(host_lib, "uastc_" + kernel)(*args, None)

    monkeypatch.setattr(xla_order, "launch", launch)
    ck.reset_launch_counts()


def _blocks(seed, n=N_BLOCKS):
    """(n, 16, 4) float32 RGBA blocks, whole numbers 0..255: textured,
    then a fifth unstructured, a tenth solid, a tenth two-tone."""
    rng = np.random.default_rng(seed)
    px = rng.integers(0, 256, (n, 1, 4)) + rng.integers(-30, 31, (n, 16, 4))
    k = n // 10
    px[:2 * k] = rng.integers(0, 256, (2 * k, 16, 4))
    px[2 * k:3 * k] = px[2 * k:3 * k, :1]
    two = rng.integers(0, 256, (k, 2, 4))
    px[3 * k:4 * k] = np.where(rng.integers(0, 2, (k, 16, 1)) == 1,
                               two[:, :1], two[:, 1:])
    return torch.as_tensor(np.clip(px, 0, 255).astype(np.float32))


def _same(got, want, launches):
    assert len(got) == len(want)
    for g, w in zip(got, want):
        assert type(g) is torch.Tensor and g.dtype == w.dtype
        assert torch.equal(g, w)
    assert {k: v for k, v in ck.LAUNCHES.items() if v} == launches


# (label, weight bits, endpoint range, comps, subsets, pattern list, top-k,
# least-squares steps): the search's modes at effort 2 (4 candidates, 1
# step) and 3 (8 candidates, 2 steps), and each instance at other weight
# bits
SUBSET_CASES = [
    ("mode2", 3, 8, 3, 2, 2, 4, 1),
    ("mode4", 2, 12, 3, 2, 2, 4, 1),
    ("mode9", 2, 8, 4, 2, 2, 4, 1),
    ("mode16", 2, 20, 2, 2, 2, 4, 1),
    ("mode2-e3", 3, 8, 3, 2, 2, 8, 2),
    ("mode7-e3", 2, 12, 3, 2, 7, 8, 2),
    ("mode3", 2, 7, 3, 3, 3, 2, 1),
    ("mode3-e3", 2, 7, 3, 3, 3, 2, 2),
    ("mode3-top8", 2, 7, 3, 3, 3, 8, 1),
    ("C3-L2", 1, 20, 3, 2, 2, 4, 2),
    ("C4-L32", 5, 11, 4, 2, 2, 8, 1),
    ("C2-L2", 1, 20, 2, 2, 2, 8, 2),
    ("C2-L32", 5, 11, 2, 2, 2, 4, 1),
    ("C4-L16", 4, 13, 4, 2, 7, 4, 2),
]


@pytest.mark.parametrize("case", SUBSET_CASES, ids=[c[0] for c in SUBSET_CASES])
def test_subset_trial_kernel_is_the_plain_version(on_host, case):
    """One `uastc_subset_trial` launch gives the errors, endpoint codes,
    weights and patterns of `subset_trial_reference`, every block."""
    _, wb, ep_range, comps, n_sub, plist, topk, ls = case
    px = _blocks(wb + 10 * comps + 100 * n_sub + topk)
    args = (wb, ep_range, comps, ls, n_sub, plist, topk)
    got = uenc.subset_trial(px.as_subclass(_Card), *args)
    _same(got, uenc.subset_trial_reference(px, *args),
          {"uastc_subset_trial": 1})


# (weight bits, endpoint range, channels, least-squares steps): modes 6,
# 11, 13 and 17 at effort 2 and 3, and other weight bits
DUAL_CASES = [(2, 18, 3, 1), (2, 13, 4, 1), (1, 20, 4, 1), (2, 20, 2, 1),
              (2, 18, 3, 2), (1, 20, 4, 2), (5, 11, 4, 1), (3, 19, 3, 1),
              (4, 13, 2, 2)]


@pytest.mark.parametrize("wb,ep_range,n_ch,ls", DUAL_CASES)
def test_dualplane_trial_kernel_is_the_plain_version(on_host, wb, ep_range,
                                                     n_ch, ls):
    """One `uastc_dualplane_trial` launch gives the errors, endpoint codes,
    interleaved weights and ccs (LA: none) of `dualplane_trial_reference`,
    every block."""
    px = _blocks(wb + 10 * n_ch + 100 * ls)
    got = uenc.dualplane_trial(px.as_subclass(_Card), wb, ep_range, ls, n_ch)
    _same(got, uenc.dualplane_trial_reference(px, wb, ep_range, ls, n_ch),
          {"uastc_dualplane_trial": 1})


def _corner_patterns(n_sub):
    """(P, 16) int64 partition patterns that force the fits' corners: pixel
    0 alone in subset 1 (so subset 0's fit sees pixel 0 masked out, its
    centred value (x - mean) * 0 = -0 where it lies below the mean), an
    empty subset (the count's max(., 1)), one pixel alone elsewhere, and
    duplicates, whose candidates tie (the earlier must win)."""
    pats = np.zeros((6, 16), np.int64)
    pats[0, 0] = 1
    pats[2, 5] = 1
    pats[4, 8:] = 1
    if n_sub == 3:
        pats[0, 1] = 2                     # subsets of one pixel each
        pats[2, 9:] = 2
        pats[4, 12:] = 2
        pats[1, :8] = 1                    # subset 2 empty
    pats[3] = pats[0]
    pats[5] = pats[4]
    return torch.as_tensor(pats)


# (comps, subsets, weight bits, least-squares steps)
CORNER_CASES = [(3, 2, 3, 1), (4, 2, 2, 2), (2, 2, 2, 1), (2, 2, 5, 2),
                (3, 3, 2, 2), (3, 3, 1, 1)]


@pytest.mark.parametrize("comps,n_sub,wb,ls", CORNER_CASES)
def test_subset_trial_kernel_corner_patterns(on_host, monkeypatch, comps,
                                             n_sub, wb, ls):
    """`_corner_patterns` in place of the mode's, every candidate
    shortlisted: a one-pixel subset, an empty subset, pixel 0 masked out
    with a centred value of -0 (pixel 0 black in half the blocks), and
    candidates that tie on error, where the earlier in shortlist order
    wins (duplicates: the second of a pair never wins)."""
    pats = _corner_patterns(n_sub)
    monkeypatch.setattr(uenc, "_patterns", lambda *a: pats)
    px = _blocks(7 * comps + n_sub + 10 * wb)
    px[::2, 0, :3] = 0.0
    args = (wb, 20 if n_sub == 2 else 7, comps, ls, n_sub, 2, len(pats))
    args = args[:-1] + (min(8, len(pats)),)
    got = uenc.subset_trial(px.as_subclass(_Card), *args)
    _same(got, uenc.subset_trial_reference(px, *args),
          {"uastc_subset_trial": 1})
    pat = got[3]
    assert not torch.any((pat == 3) | (pat == 5))
    assert torch.any(pat == 0) and torch.any(pat == 4)


@pytest.mark.parametrize("n_ch,wb,ls", [(3, 2, 1), (4, 2, 2), (4, 1, 1),
                                        (2, 2, 2)])
def test_dualplane_trial_kernel_ties_take_the_first_ccs(on_host, n_ch, wb,
                                                         ls):
    """Gray blocks (R = G = B, and A with them for 4 channels) give every
    channel choice the same error: the first (ccs 0) wins, as in the plain
    version; LA's luma is fractional there."""
    px = _blocks(3 * n_ch + wb + 10 * ls)
    k = len(px) // 2
    px[:k, :, 1:3 if n_ch == 3 else 4] = px[:k, :, :1]
    got = uenc.dualplane_trial(px.as_subclass(_Card), wb, 18, ls, n_ch)
    _same(got, uenc.dualplane_trial_reference(px, wb, 18, ls, n_ch),
          {"uastc_dualplane_trial": 1})
    if n_ch != 2:
        assert torch.all(got[3][:k] == 0)


# the instances at block counts that are not a multiple of their blocks
# per CTA (4 warps of up to 32 / fits-a-block blocks each): (label, subset
# or dual-plane arguments, the least count at which a warp takes its most
# blocks: 8 for mode 17, 4 for modes 2, 3, 16, 6 and 11; None where that
# is two blocks, as at every count, or one: mode 3 at top-k 8, its pass
# over the pixels half a warp with no block)
COUNT_CASES = [("mode2", (3, 8, 3, 1, 2, 2, 4), 4300),
               ("mode7-e3", (2, 12, 3, 2, 2, 7, 8), None),
               ("mode3", (2, 7, 3, 1, 3, 3, 2), 4300),
               ("mode3-top8", (2, 7, 3, 1, 3, 3, 8), None),
               ("mode16", (2, 20, 2, 1, 2, 2, 4), 4300),
               ("mode6", (2, 18, 1, 3), 4300), ("mode11", (2, 13, 1, 4), 4300),
               ("mode17", (2, 20, 1, 2), 8500)]
COUNTS = [(c[:2], n) for c in COUNT_CASES
          for n in (1, 403, 1001) + ((c[2],) if c[2] else ())]


@pytest.mark.parametrize("case,n", COUNTS,
                         ids=[f"{c[0]}-{n}" for c, n in COUNTS])
def test_trial_kernels_at_ragged_block_counts(on_host, case, n):
    """Both trials at 1, 403 and 1,001 blocks (two blocks a warp) and at
    the count where a warp takes its most blocks: a CTA whose last warps,
    or a warp whose last blocks, have no block of their own (the last
    block repeats and is written once)."""
    label, args = case
    px = _blocks(len(label) + n, n=n)
    if len(args) == 7:
        got = uenc.subset_trial(px.as_subclass(_Card), *args)
        _same(got, uenc.subset_trial_reference(px, *args),
              {"uastc_subset_trial": 1})
    else:
        got = uenc.dualplane_trial(px.as_subclass(_Card), *args)
        _same(got, uenc.dualplane_trial_reference(px, *args),
              {"uastc_dualplane_trial": 1})


@pytest.mark.parametrize("case", [c[:2] for c in COUNT_CASES[::3]],
                         ids=[c[0] for c in COUNT_CASES[::3]])
def test_trial_kernels_take_strided_pixels(on_host, case):
    """Both trials on a strided view of the pixels (every other channel of
    a wider tensor, as `tests/test_torch_cuda.py` passes them): the
    strides reach the kernels as given."""
    label, args = case
    wide = _blocks(len(label)).repeat(1, 1, 2)
    px = wide[:, :, ::2]
    assert not px.is_contiguous()
    fn, ref = ((uenc.subset_trial, uenc.subset_trial_reference)
               if len(args) == 7 else
               (uenc.dualplane_trial, uenc.dualplane_trial_reference))
    got = fn(px.as_subclass(_Card), *args)
    _same(got, ref(px.contiguous(), *args),
          {"uastc_subset_trial" if len(args) == 7
           else "uastc_dualplane_trial": 1})


# (weight bits, endpoint range, top-k, steps): LA's chains in pixel order,
# whose luma is fractional, at more shapes
LA_CASES = [(3, 20, 8, 2), (1, 20, 4, 1), (4, 13, 2, 2)]


@pytest.mark.parametrize("wb,ep_range,topk,ls", LA_CASES)
def test_la_trials_keep_their_chains(on_host, wb, ep_range, topk, ls):
    """The LA subset trial (mode 16's instance) and the LA dual-plane trial
    (mode 17's) at more weight bits, top-k and steps: their fractional
    error chains in pixel order give the plain version's bits."""
    px = _blocks(wb + 5 * topk + 50 * ls)
    args = (wb, ep_range, 2, ls, 2, 2, topk)
    got = uenc.subset_trial(px.as_subclass(_Card), *args)
    _same(got, uenc.subset_trial_reference(px, *args),
          {"uastc_subset_trial": 1})
    ck.reset_launch_counts()
    got = uenc.dualplane_trial(px.as_subclass(_Card), wb, ep_range, ls, 2)
    _same(got, uenc.dualplane_trial_reference(px, wb, ep_range, ls, 2),
          {"uastc_dualplane_trial": 1})


@pytest.mark.parametrize("n_ch,n_sub,wb,ls", [
    (3, 2, 3, 1), (4, 2, 2, 2), (2, 2, 5, 1), (3, 3, 2, 2), (1, 1, 1, 1),
    (4, 1, 4, 2)])
def test_line_fit_kernel_is_the_plain_version(on_host, n_ch, n_sub, wb, ls):
    """`uastc_line_fit`, whose per-subset body the trials share, gives
    `line_fit_reference`'s endpoints on a strided view of the pixels (the
    last C channels), with labels of the modes' own patterns (none for one
    subset)."""
    px = _blocks(n_ch + 10 * n_sub + 100 * wb)
    v = px[..., 4 - n_ch:]
    levels = torch.as_tensor(uenc._weight_levels(wb))
    label = None
    if n_sub > 1:
        pats = uenc._patterns(n_sub, False, "cpu")
        rng = np.random.default_rng(n_ch + n_sub)
        label = pats[torch.as_tensor(rng.integers(0, len(pats), len(px)))]
    got = uenc.line_fit(v.as_subclass(_Card), label, n_sub, levels, ls)
    _same(got, uenc.line_fit_reference(v, label, n_sub, levels, ls),
          {"uastc_line_fit": 1})


# (comps, weight bits, least-squares steps, endpoint range): each
# instance at weight bits 1..5 (the range by the weight bits), then every
# single-subset mode of the search (`pack.ALL_MODES`: RGB 0, 1, 5, 18, RGBA
# 10, 12, 14, LA 15) at 1 and 2 steps
MODE_CASES = [pytest.param(2, 2, 1, None, id="2-2-1"),
              pytest.param(3, 3, 2, None, id="3-3-2"),
              pytest.param(4, 5, 1, None, id="4-5-1"),
              pytest.param(3, 1, 1, None, id="3-1-1")]
MODE_CASES += [pytest.param(comps, wb, ls, ep_range, id=f"mode{mode}-ls{ls}")
               for mode, wb, ep_range, comps in pack.ALL_MODES
               for ls in (1, 2)]
_EP_RANGE = {1: 20, 2: 20, 3: 19, 4: 13, 5: 11}


@pytest.mark.parametrize("comps,wb,ls,ep_range", MODE_CASES)
def test_mode_trial_kernel_is_the_plain_version(on_host, comps, wb, ls,
                                                ep_range):
    """`uastc_mode_trial` gives `mode_trial_reference`'s errors, codes and
    weights."""
    if ep_range is None:  # the instance cases, on their own blocks
        px, ep_range = _blocks(comps + 10 * wb), _EP_RANGE[wb]
    else:
        px = _blocks(comps + 10 * wb + 100 * ls)
    got = uenc._mode_trial(px.as_subclass(_Card), wb, ep_range, comps, ls)
    _same(got, uenc.mode_trial_reference(px, wb, ep_range, comps, ls),
          {"uastc_mode_trial": 1})


# (label, weight bits, endpoint range, comps, steps): one mode of each
# instance, mode 18 (32 levels) and LA's fractional chains among them
MODE_SHAPES = [("mode0", 4, 19, 3, 1), ("mode18", 5, 11, 3, 2),
               ("mode10", 4, 13, 4, 1), ("mode15", 4, 20, 2, 2)]
MODE_COUNTS = [(c, n) for c in MODE_SHAPES for n in (1, 33, 1001)]


@pytest.mark.parametrize("case,n", MODE_COUNTS,
                         ids=[f"{c[0]}-{n}" for c, n in MODE_COUNTS])
def test_mode_trial_kernel_at_ragged_block_counts(on_host, case, n):
    """1, 33 and 1,001 blocks: a warp, or a CTA, whose last blocks or warps
    have no block of their own (the last block repeats, written once)."""
    label, wb, ep_range, comps, ls = case
    px = _blocks(len(label) + n, n=n)
    got = uenc._mode_trial(px.as_subclass(_Card), wb, ep_range, comps, ls)
    _same(got, uenc.mode_trial_reference(px, wb, ep_range, comps, ls),
          {"uastc_mode_trial": 1})


@pytest.mark.parametrize("case", MODE_SHAPES, ids=[c[0] for c in MODE_SHAPES])
def test_mode_trial_kernel_takes_strided_pixels(on_host, case):
    """Strided views of the pixels: every other channel of a wider tensor,
    planar channels (a channel stride of 16 n), and rows of 65 floats
    (contiguous pixels, but a block's start 16-byte aligned only in every
    fourth block): the kernel's element loads, not its 16-byte ones."""
    label, wb, ep_range, comps, ls = case
    wide = _blocks(len(label) + 1).repeat(1, 1, 2)
    rows = torch.cat([_blocks(len(label) + 3).reshape(N_BLOCKS, 64),
                      torch.zeros(N_BLOCKS, 1)], 1)
    planar = _blocks(len(label) + 2).permute(2, 0, 1).contiguous()
    views = [wide[:, :, ::2], planar.permute(1, 2, 0),
             rows.as_strided((N_BLOCKS, 16, 4), (65, 4, 1))]
    for px in views:
        assert not px.is_contiguous()
        ck.reset_launch_counts()
        got = uenc._mode_trial(px.as_subclass(_Card), wb, ep_range, comps, ls)
        _same(got, uenc.mode_trial_reference(px.contiguous(), wb, ep_range,
                                             comps, ls),
              {"uastc_mode_trial": 1})


def _flat_blocks(seed, n=N_BLOCKS):
    """Blocks whose fits are degenerate or tie: solid (zero covariance, the
    axis 0 / (sqrt(0) + 1e-6)), two-level (rank one), gray (R = G = B: the
    LA luma whole), channels of one or two values (rank one or two), and a
    spread of 0..3 around a value, whose reconstructions at 16 or 32
    levels repeat, so that a pixel's least error is reached at several
    levels (the first is taken)."""
    rng = np.random.default_rng(seed)
    base = rng.integers(0, 256, (n, 1, 4))
    kind = np.arange(n) % 5
    px = np.broadcast_to(base, (n, 16, 4)).copy()
    two = rng.integers(0, 256, (n, 1, 4))
    pick = rng.integers(0, 2, (n, 16, 1)) == 1
    px = np.where((kind == 1)[:, None, None] & pick, two, px)
    gray = np.where(pick, two[..., :1], base[..., :1])
    px[kind == 2, :, :3] = gray[kind == 2]
    px[kind == 3, :, 1] = rng.integers(0, 256, (n, 16))[kind == 3]
    px = np.where((kind == 4)[:, None, None],
                  base + rng.integers(0, 4, (n, 16, 4)), px)
    return torch.as_tensor(np.clip(px, 0, 255).astype(np.float32))


@pytest.mark.parametrize("case", MODE_SHAPES, ids=[c[0] for c in MODE_SHAPES])
def test_mode_trial_kernel_degenerate_blocks_and_ties(on_host, case):
    """`_flat_blocks`: zero and rank-one covariance, endpoints that clamp,
    a singular least-squares system, and level searches that tie; every
    output the plain version's."""
    label, wb, ep_range, comps, ls = case
    px = _flat_blocks(len(label) + wb)
    got = uenc._mode_trial(px.as_subclass(_Card), wb, ep_range, comps, ls)
    _same(got, uenc.mode_trial_reference(px, wb, ep_range, comps, ls),
          {"uastc_mode_trial": 1})
    # the ties are there: pixels whose least error, through the winning
    # codes, is reached at more than one level
    _, unq, wlev = uenc._mode_consts(wb, ep_range, "cpu")
    ep = got[1].long()
    acc = (unq[ep[:, 0::2]][:, None] * (64.0 - wlev)[None, :, None]
           + unq[ep[:, 1::2]][:, None] * wlev[None, :, None])
    rec = torch.floor((acc * 257.0 + 32.0) / 16384.0)          # (B, L, C)
    v = uenc._la(px) if comps == 2 else px[..., :comps]
    e = ((v[:, :, None, :] - rec[:, None]) ** 2).sum(-1)       # (B, 16, L)
    assert ((e == e.amin(-1, keepdim=True)).sum(-1) > 1).any()


def _split(host_lib, px, wb, ep_range, comps, ls, stop=6, nb=0, warps=0):
    """`uastc_mode_trial_split` of the host build on px: (status, err, ep,
    w)."""
    inv, unq, wlev = uenc._mode_consts(wb, ep_range, "cpu")
    n = px.shape[0]
    err = torch.full((n,), float("nan"))
    ep = torch.full((n, 2 * comps), -1, dtype=torch.int32)
    w = torch.full((n, 16), -1, dtype=torch.int32)
    status = host_lib.uastc_mode_trial_split(
        px.data_ptr(), *px.stride(), inv.data_ptr(), unq.data_ptr(),
        unq.numel(), wlev.data_ptr(), wlev.numel(), comps, ls,
        err.data_ptr(), ep.data_ptr(), w.data_ptr(), n, stop, nb, warps, None)
    return status, err, ep, w


# (blocks per warp, warps per CTA, blocks): one block a warp, an odd count
# (half a pass without a block), the launcher's most (16) at one and two
# warps a CTA, each with a last warp and a last CTA that are not full
LAUNCH_SHAPES = [(1, 4, 7), (3, 2, 23), (15, 1, 40), (16, 2, 161),
                 (16, 1, 70), (8, 3, 101)]


@pytest.mark.parametrize("nb,warps,n", LAUNCH_SHAPES)
@pytest.mark.parametrize("case", MODE_SHAPES[1:], ids=[c[0] for c in
                                                        MODE_SHAPES[1:]])
def test_mode_trial_kernel_at_every_launch_shape(host_lib, case, nb, warps,
                                                 n):
    """The kernel at blocks per warp and warps per CTA other than the
    launcher's choice (the measurement entry's): the same outputs."""
    label, wb, ep_range, comps, ls = case
    px = _blocks(nb + warps + n, n=n)
    status, *got = _split(host_lib, px, wb, ep_range, comps, ls, nb=nb,
                          warps=warps)
    assert status == 0
    for g, want in zip(got, uenc.mode_trial_reference(px, wb, ep_range,
                                                      comps, ls)):
        assert torch.equal(g, want)


def test_mode_trial_split_stops_at_its_steps(host_lib):
    """The per-step split's instances: each stop writes every block's err
    (finite) and nothing else; RGBA's error after the first search is the
    trial's without a least-squares step, after the steps the trial's; the
    last stop is the trial; shapes past the kernel's are refused."""
    px = _blocks(5, n=45)
    wb, ep_range, ls = 4, 13, 2
    for stop in range(1, 6):
        status, err, ep, w = _split(host_lib, px, wb, ep_range, 4, ls, stop)
        assert status == 0 and torch.all(torch.isfinite(err))
        assert torch.all(ep == -1) and torch.all(w == -1)
        if stop == 4:
            want = uenc.mode_trial_reference(px, wb, ep_range, 4, 0)[0]
            assert torch.equal(err, want)
        if stop == 5:
            want = uenc.mode_trial_reference(px, wb, ep_range, 4, ls)[0]
            assert torch.equal(err, want)
    status, *got = _split(host_lib, px, wb, ep_range, 4, ls, 6)
    assert status == 0
    for g, want in zip(got, uenc.mode_trial_reference(px, wb, ep_range, 4,
                                                      ls)):
        assert torch.equal(g, want)
    for stop, nb, warps in ((0, 0, 0), (7, 0, 0), (6, 17, 0), (6, 0, 5),
                            (6, 16, 4)):
        assert _split(host_lib, px, 5, 11, 2, ls, stop, nb, warps)[0] != 0


def test_trial_wrappers_refuse_what_the_kernels_do_not_take(on_host):
    """Shapes, instances and top-k outside the kernels' range raise before
    any launch; a status other than 0 raises."""
    px = _blocks(1).as_subclass(_Card)
    with pytest.raises(ValueError):
        uenc.subset_trial(px, 2, 8, 4, 1, 3)             # no (4, 3) instance
    with pytest.raises(ValueError):
        uenc.subset_trial(px, 2, 7, 3, 1, 3, 3, 12)      # top-k past 11
    with pytest.raises(ValueError):
        uenc.subset_trial(px[:, :8], 2, 8, 3, 1)
    with pytest.raises(ValueError):
        uenc.dualplane_trial(px, 2, 18, 1, 1)
    with pytest.raises(ValueError):
        uenc.dualplane_trial(px.double(), 2, 18, 1, 3)
    assert not any(ck.LAUNCHES.values())
    with pytest.raises(RuntimeError, match="uastc_subset_trial"):
        uenc.subset_trial(px, 2, 8, 3, -1)               # the kernel refuses
