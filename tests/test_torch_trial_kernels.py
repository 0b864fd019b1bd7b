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
bits 1..5 and the top-k of the searches. Tolerance: none, every output
equal (`torch.equal`). Card tests of the same kernels:
`tests/test_torch_cuda.py`.
"""

import ctypes
import pathlib
import re
import subprocess

import numpy as np
import pytest
import torch

from basis_universal_tpu_torch.codecs.uastc import encode as uenc
from basis_universal_tpu_torch.ops import _build, xla_order
from basis_universal_tpu_torch.ops import cuda_etc1s as ck

TESTS = pathlib.Path(__file__).resolve().parent
KERNEL = TESTS.parent / "basis_universal_tpu_torch" / "csrc" / \
    "xla_order_kernels.cu"
N_BLOCKS = 403
# a launch `kernel<T...><<<grid, block, 0, stream>>>(`, the grid one level
# of parentheses deep
_LAUNCH = re.compile(r"(\w+(?:<[^<>;]*>)?)<<<\s*((?:[^,()]|\([^()]*\))+),"
                     r"\s*(\w+),\s*0,\s*\w+>>>\(")


@pytest.fixture(scope="module")
def host_lib(tmp_path_factory):
    """`csrc/xla_order_kernels.cu` built for the host against
    `cuda_host_stub.h`, its C entries declared as `_build` declares the
    card library's."""
    src = KERNEL.read_text().replace(
        "#include <cuda_runtime.h>", f'#include "{TESTS / "cuda_host_stub.h"}"')
    n_launch = src.count("<<<")
    src, n = _LAUNCH.subn(r"emu_launch(\1, \2, \3, ", src)
    assert n == n_launch
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


@pytest.mark.parametrize("comps,wb,ls", [(2, 2, 1), (3, 3, 2), (4, 5, 1),
                                         (3, 1, 1)])
def test_mode_trial_kernel_is_the_plain_version(on_host, comps, wb, ls):
    """`uastc_mode_trial` gives `mode_trial_reference`'s errors, codes and
    weights."""
    px = _blocks(comps + 10 * wb)
    ep_range = {1: 20, 2: 20, 3: 19, 4: 13, 5: 11}[wb]
    got = uenc._mode_trial(px.as_subclass(_Card), wb, ep_range, comps, ls)
    _same(got, uenc.mode_trial_reference(px, wb, ep_range, comps, ls),
          {"uastc_mode_trial": 1})


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
