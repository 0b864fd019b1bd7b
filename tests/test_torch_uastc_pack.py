"""The UASTC block packing on the search's device
(`basis_universal_tpu_torch/codecs/uastc/pack.py`: the table buffer of
`pack_tables`, the plain version `pack_reference` that a CPU tensor runs,
and the kernel `uastc_pack` of `csrc/uastc_pack_kernels.cu`) against the
numpy packers, the port's copy (`pack._pack_from_compact`) and the
reference's (`basis_universal_tpu.codecs.uastc.encode._pack_from_compact`),
on the CPU.

Inputs, made from a seed with numpy: the port's search buffers of synthetic
RGB and RGBA blocks (a 64x64 texture plus solid, two-tone and noise blocks)
at efforts 1-4; buffers drawn so that every slot of the slot list wins
blocks, with every pattern index of each list, every ccs, endpoint codes 0
and the range's maximum, anchor weights with their top bit set and clear,
and rows of no slot; and solid blocks whose colours tie in the ETC1 hint's
LUT search. The kernel's source runs here compiled with g++ against
`tests/cuda_host_stub.h` (a fiber per CUDA thread) and is called
through ctypes on CPU tensors. Tolerance: none, every byte equal.
"""

import ctypes
import pathlib
import re
import subprocess

import numpy as np
import pytest
import torch

import basis_universal_tpu.ops.etc1s_encode  # noqa: F401  (before tracing)
from basis_universal_tpu.codecs.uastc import encode as ref_encode
from basis_universal_tpu_torch.codecs.uastc import encode as port_encode
from basis_universal_tpu_torch.codecs.uastc import pack
from basis_universal_tpu_torch.codecs.uastc import tables as T
from basis_universal_tpu_torch.ops import cuda_etc1s as ck
from basis_universal_tpu_torch.ops.etc1 import image_to_blocks
from basis_universal_tpu_torch.testing.synthetic import synthetic_texture

TESTS = pathlib.Path(__file__).resolve().parent
KERNEL = TESTS.parent / "basis_universal_tpu_torch" / "csrc" / \
    "uastc_pack_kernels.cu"
EFFORTS = [(e, a) for e in (1, 2, 3, 4) for a in (False, True)]
EFFORT_IDS = [f"e{e}-{'rgba' if a else 'rgb'}" for e, a in EFFORTS]


@pytest.fixture(autouse=True)
def _one_thread():
    """Thousands of small operators: one intra-op thread runs them as fast
    and leaves the other test workers their cores."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


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


def _slot_modes(modes, extra):
    """(mode, weight bits, endpoint range, comps) of each slot of the
    winner buffer, None for the solid colour."""
    return list(modes) + [None] + [pack.EXTRA_MODES[n] for n in extra]


def _patterns(mode):
    """The partition list a mode's aux column indexes (None: it has none)."""
    if mode == 7:
        return T.BC7_3_ASTC2_COMMON_PARTITIONS, 2
    if T.MODE_SUBSETS[mode] == 3:
        return T.ASTC_BC7_COMMON_PARTITIONS3, 3
    if T.MODE_SUBSETS[mode] == 2:
        return T.ASTC_BC7_COMMON_PARTITIONS2, 2
    return None


def _anchors(mode, aux):
    """The weights whose top bit decides a flip."""
    if T.MODE_PLANES[mode] == 2:
        return [0, 1]
    listed = _patterns(mode)
    if listed is None:
        return [0]
    lst, n_sub = listed
    return list(T.pattern_anchors(lst[aux][1], n_sub))


def _drawn(effort, alpha, seed):
    """(compact (B, 59) uint8, alpha0 (B,) int32): per slot, 4 rows per
    pattern index (per ccs in a dual-plane mode with one, 8 rows in the
    others): endpoint codes all 0, all the range maximum, or each of 0, the
    maximum or a random code; random weights with the anchors' top bit set
    in even rows and clear in odd ones; then 8 rows of no slot."""
    modes, _, extra, _ = pack._effort_mode_set(effort, alpha)
    rng = np.random.default_rng(seed)
    rows = []
    for slot, m in enumerate(_slot_modes(modes, extra)):
        if m is None:
            c = rng.integers(0, 256, (64, 59))
            c[:, 0] = slot
            rows.append(c)
            continue
        mode, wb, ep_range, comps = m
        top_code = len(T.color_unquant_table(ep_range)) - 1
        listed = _patterns(mode)
        if listed is not None:
            auxes = [a for a in range(len(listed[0])) for _ in range(4)]
        elif T.MODE_PLANES[mode] == 2 and mode != 17:
            auxes = [a for a in range(comps) for _ in range(4)]
        else:
            auxes = list(rng.integers(0, 256, 8))          # aux unread
        for k, aux in enumerate(auxes):
            c = rng.integers(0, 256, 59)
            c[0], c[57] = slot, aux
            pick = rng.integers(0, 3, 24) if k % 4 >= 2 else \
                np.full(24, k % 4)
            c[1:25] = np.choose(pick, [np.zeros(24, np.int64),
                                       np.full(24, top_code),
                                       rng.integers(0, top_code + 1, 24)])
            c[25:57] = rng.integers(0, 1 << wb, 32)
            msb = 1 << (wb - 1)
            for a in _anchors(mode, aux):
                c[25 + a] = (c[25 + a] | msb) if k % 2 == 0 else \
                    (c[25 + a] & ~msb)
            rows.append(c[None])
    c = rng.integers(0, 256, (8, 59))
    c[:, 0] = rng.integers(len(modes) + 1 + len(extra), 256, 8)
    rows.append(c)
    compact = np.concatenate(rows).astype(np.uint8)
    alpha0 = rng.integers(0, 1024, compact.shape[0]).astype(np.int32)
    return compact, alpha0


def _numpy_packs(compact, alpha0, modes, extra):
    """The port's and the reference's numpy packers on the buffer, pixel 0's
    alpha alpha0 (the only pixel they read)."""
    px = np.zeros((compact.shape[0], 16, 4), np.float32)
    px[:, 0, 3] = alpha0
    return (pack._pack_from_compact(compact, px, modes, extra),
            ref_encode._pack_from_compact(compact, px, modes, extra))


def _plain(compact, alpha0, modes, extra):
    return pack.uastc_pack(torch.from_numpy(compact),
                           torch.from_numpy(alpha0),
                           pack.pack_tables(modes, extra)).numpy()


@pytest.mark.parametrize("effort,alpha", EFFORTS, ids=EFFORT_IDS)
def test_pack_tables(effort, alpha):
    """One int32 buffer per slot list, cached: the header, a record per
    slot (the kind and mode of `_pack_from_compact`'s slot), the patterns
    before `MAX_PREFIX_WORDS`, the solid-colour LUT last."""
    modes, _, extra, _ = pack._effort_mode_set(effort, alpha)
    tabs = pack.pack_tables(modes, extra)
    assert tabs is pack.pack_tables(modes, extra, "cpu")
    assert tabs.dtype == torch.int32 and tabs.device.type == "cpu"
    n_slots, slots_ofs, lut_ofs, n_words = tabs[:4].tolist()
    assert n_slots == len(modes) + 1 + len(extra)
    assert n_words == tabs.numel() == lut_ofs + pack.LUT_WORDS
    assert lut_ofs <= pack.MAX_PREFIX_WORDS
    recs = tabs[slots_ofs:slots_ofs + n_slots * pack.SLOT_WORDS].reshape(
        n_slots, pack.SLOT_WORDS)
    for rec, m in zip(recs.tolist(), _slot_modes(modes, extra)):
        if m is None:
            assert rec[pack.S_KIND] == pack.KIND_SOLID
            assert rec[pack.S_MODE] == T.MODE_SOLID
            continue
        mode, wb, ep_range, comps = m
        assert rec[pack.S_MODE] == mode and rec[pack.S_WB] == wb
        assert rec[pack.S_RANGE] == ep_range and rec[pack.S_COMPS] == comps
        assert (rec[pack.S_KIND] == pack.KIND_DUAL) == (
            T.MODE_PLANES[mode] == 2)
        listed = _patterns(mode)
        assert rec[pack.S_PAT_COUNT] == (1 if listed is None
                                         else len(listed[0]))
    errs, bests = pack._solid_etc1_luts()
    lut = tabs[lut_ofs:].reshape(32, 256).numpy()
    np.testing.assert_array_equal(lut & 0xFFFF, errs)
    np.testing.assert_array_equal(lut >> 16, bests)


@pytest.mark.parametrize("effort,alpha", EFFORTS, ids=EFFORT_IDS)
def test_plain_version_on_search_buffers(effort, alpha):
    """On the port's search buffer (the reference's, held in
    `test_torch_uastc_encode.py`), `pack_reference` gives both numpy
    packers' bytes; `encode_blocks(..., device="cpu")` gives those bytes,
    packing through it and launching nothing."""
    px = _blocks(40 + effort, alpha)
    modes, ls_iters, extra, topk = pack._effort_mode_set(effort, alpha)
    compact = port_encode._search(torch.from_numpy(px), modes, ls_iters,
                                  extra, topk)
    print(f"effort {effort} alpha {alpha}: {len(np.unique(compact[:, 0]))} "
          f"of {len(modes) + 1 + len(extra)} slots won some block")
    alpha0 = px[:, 0, 3].astype(np.int32)
    mine, theirs = _numpy_packs(compact, alpha0, modes, extra)
    np.testing.assert_array_equal(mine, theirs)
    np.testing.assert_array_equal(_plain(compact, alpha0, modes, extra), mine)
    ck.reset_launch_counts()
    np.testing.assert_array_equal(
        port_encode.encode_blocks(px, effort, alpha, device="cpu"), mine)
    assert not any(ck.LAUNCHES.values())


@pytest.mark.parametrize("effort,alpha", EFFORTS, ids=EFFORT_IDS)
def test_plain_version_on_drawn_buffers(effort, alpha):
    """Every slot, pattern index and ccs, endpoint codes 0 and the maximum,
    anchors with the top bit set and clear, rows of no slot (zeros), and
    alphas past 255 (their low 8 bits)."""
    compact, alpha0 = _drawn(effort, alpha, 10 * effort + alpha)
    modes, _, extra, _ = pack._effort_mode_set(effort, alpha)
    assert set(np.unique(compact[:, 0])) >= set(
        range(len(modes) + 1 + len(extra)))
    mine, theirs = _numpy_packs(compact, alpha0, modes, extra)
    np.testing.assert_array_equal(mine, theirs)
    np.testing.assert_array_equal(_plain(compact, alpha0, modes, extra), mine)
    assert not mine[compact[:, 0] >= len(modes) + 1 + len(extra)].any()


def test_solid_blocks_on_lut_ties():
    """Solid colours whose 32 (intensity, selector) combinations tie at the
    least error: the first of them, as `np.argmin` takes it."""
    errs, _ = pack._solid_etc1_luts()
    rng = np.random.default_rng(5)
    rgb = np.concatenate([np.repeat(np.arange(256)[:, None], 3, 1),
                          rng.integers(0, 256, (20000, 3))])
    e = sum(errs[:, rgb[:, ch]].astype(np.int64) ** 2 for ch in range(3))
    tied = (e == e.min(0)).sum(0) > 1
    rgb = rgb[tied]
    print(f"{len(rgb)} tied colours")
    assert len(rgb) > 1000
    modes, _, extra, _ = pack._effort_mode_set(2, True)
    compact = rng.integers(0, 256, (len(rgb), 59)).astype(np.uint8)
    compact[:, 0] = len(modes)
    compact[:, 1:4] = rgb
    alpha0 = rng.integers(0, 256, len(rgb)).astype(np.int32)
    mine, theirs = _numpy_packs(compact, alpha0, modes, extra)
    np.testing.assert_array_equal(mine, theirs)
    np.testing.assert_array_equal(_plain(compact, alpha0, modes, extra), mine)


def test_uastc_pack_checks_its_inputs():
    modes, _, extra, _ = pack._effort_mode_set(2, False)
    tabs = pack.pack_tables(modes, extra)
    c = torch.zeros((4, 59), dtype=torch.uint8)
    a = torch.zeros(4, dtype=torch.int32)
    with pytest.raises(TypeError):
        pack.uastc_pack(c.int(), a, tabs)
    with pytest.raises(ValueError):
        pack.uastc_pack(c[:, :58].contiguous(), a, tabs)
    with pytest.raises(ValueError):
        pack.uastc_pack(c, a[:3], tabs)
    with pytest.raises(TypeError):
        pack.uastc_pack(c, a.long(), tabs)
    assert pack.uastc_pack(c[:0], a[:0], tabs).shape == (0, 16)


@pytest.fixture(scope="module")
def host_kernel(tmp_path_factory):
    """`csrc/uastc_pack_kernels.cu` compiled for the host against
    `cuda_host_stub.h`; its C entry `uastc_pack`."""
    src = KERNEL.read_text().replace(
        "#include <cuda_runtime.h>", f'#include "{TESTS / "cuda_host_stub.h"}"')
    src, n = re.subn(
        r"(\w+(?:<[\w, ]+>)?)<<<([^,]+), ([^,]+), 0, [^>]+>>>\(",
        r"emu_launch(\1, \2, \3, ", src)
    assert n == 1
    out = tmp_path_factory.mktemp("uastc_pack_host")
    (out / "kernel.cpp").write_text(src)
    subprocess.run(["g++", "-std=c++20", "-O1", "-shared", "-fPIC",
                    "-pthread", "-o", str(out / "kernel.so"),
                    str(out / "kernel.cpp")], check=True)
    lib = ctypes.CDLL(str(out / "kernel.so"))
    vp = ctypes.c_void_p
    lib.uastc_pack.argtypes = [vp, vp, vp, ctypes.c_int, vp,
                               ctypes.c_longlong, vp]
    lib.uastc_pack.restype = ctypes.c_int
    lib.uastc_pack_split.argtypes = [vp, vp, vp, ctypes.c_int, vp,
                                     ctypes.c_longlong, ctypes.c_int,
                                     ctypes.c_int, vp]
    lib.uastc_pack_split.restype = ctypes.c_int
    return lib


def _kernel(lib, compact, alpha0, tabs, offset, stop=None, group=0):
    """The kernel's bytes, its buffer at `offset` bytes past a 16-byte
    boundary (0: the CTAs stage their rows with 4-byte loads; 3: byte by
    byte); with `stop` or `group` (the lanes a block, 4 or 8; 0: by the
    size, as `uastc_pack` takes them), those of `uastc_pack_split`."""
    buf = torch.zeros(compact.size + 16, dtype=torch.uint8)
    c = buf[offset:offset + compact.size].view(-1, 59)
    c.copy_(torch.from_numpy(compact))
    a = torch.from_numpy(alpha0)
    out = torch.zeros((compact.shape[0], 16), dtype=torch.uint8)
    args = (c.data_ptr(), a.data_ptr(), tabs.data_ptr(), tabs.numel(),
            out.data_ptr(), c.shape[0])
    status = (lib.uastc_pack(*args, None) if stop is None and not group
              else lib.uastc_pack_split(*args, stop or 5, group, None))
    assert status == 0
    return out.numpy()


@pytest.mark.parametrize("effort,alpha", EFFORTS, ids=EFFORT_IDS)
def test_kernel_source_on_the_host_is_the_plain_version(host_kernel, effort,
                                                        alpha):
    """The kernel's own source, on the drawn buffers (aligned, and off by
    3 bytes) and on a search buffer: `pack_reference`'s bytes."""
    modes, ls_iters, extra, topk = pack._effort_mode_set(effort, alpha)
    tabs = pack.pack_tables(modes, extra)
    compact, alpha0 = _drawn(effort, alpha, 100 + 10 * effort + alpha)
    want = _plain(compact, alpha0, modes, extra)
    for offset in (0, 3):
        for group in (0, 4):
            np.testing.assert_array_equal(_kernel(
                host_kernel, compact, alpha0, tabs, offset, group=group), want)
    px = _blocks(60 + effort, alpha)
    compact = port_encode._search(torch.from_numpy(px), modes, ls_iters,
                                  extra, topk)
    alpha0 = px[:, 0, 3].astype(np.int32)
    np.testing.assert_array_equal(
        _kernel(host_kernel, compact, alpha0, tabs, 0),
        _plain(compact, alpha0, modes, extra))


def test_kernel_source_on_solid_lut_ties(host_kernel):
    """Solid colours whose LUT combinations tie at the least error, through
    the kernel: the group of lanes keeps the first of them, as `np.argmin`
    (and the search of one lane before) takes it; mixed with rows of other
    slots, so that warps take the solid search and skip it."""
    errs, _ = pack._solid_etc1_luts()
    rng = np.random.default_rng(6)
    rgb = np.concatenate([np.repeat(np.arange(256)[:, None], 3, 1),
                          rng.integers(0, 256, (6000, 3))])
    e = sum(errs[:, rgb[:, ch]].astype(np.int64) ** 2 for ch in range(3))
    rgb = rgb[(e == e.min(0)).sum(0) > 1]
    assert len(rgb) > 300
    modes, _, extra, _ = pack._effort_mode_set(2, True)
    tabs = pack.pack_tables(modes, extra)
    compact, _ = _drawn(2, True, 77)
    solid = rng.integers(0, 256, (len(rgb), 59))
    solid[:, 0], solid[:, 1:4] = len(modes), rgb
    compact = np.concatenate([solid, compact]).astype(np.uint8)
    compact = compact[rng.permutation(len(compact))]
    alpha0 = rng.integers(0, 1024, len(compact)).astype(np.int32)
    want = _plain(compact, alpha0, modes, extra)
    for group in (0, 4):
        np.testing.assert_array_equal(
            _kernel(host_kernel, compact, alpha0, tabs, 0, group=group), want)
    np.testing.assert_array_equal(
        want, _numpy_packs(compact, alpha0, modes, extra)[0])


@pytest.mark.parametrize("n", [1, 7, 9, 61, 1001])
def test_kernel_source_on_ragged_and_sorted_rows(host_kernel, n):
    """Buffers of n blocks, n not a multiple of the CTA's 32 (the last CTA's
    rows partly absent, its lanes still at every shuffle), drawn over every
    slot of effort 4 RGBA, as drawn and with the rows sorted by slot (no
    warp spans two slots but at the boundaries), with 8 lanes a block (as
    `uastc_pack` takes them below 16,384 blocks) and with 4."""
    modes, _, extra, _ = pack._effort_mode_set(4, True)
    tabs = pack.pack_tables(modes, extra)
    compact, alpha0 = _drawn(4, True, n)
    rng = np.random.default_rng(n)
    pick = rng.choice(len(compact), n, replace=n > len(compact))
    compact, alpha0 = compact[pick], alpha0[pick]
    for rows in (np.arange(n), np.argsort(compact[:, 0], kind="stable")):
        c, a = np.ascontiguousarray(compact[rows]), alpha0[rows].copy()
        want = _plain(c, a, modes, extra)
        for offset, group in ((0, 0), (3, 0), (0, 4), (3, 4)):
            np.testing.assert_array_equal(
                _kernel(host_kernel, c, a, tabs, offset, group=group), want)


@pytest.mark.parametrize("effort,alpha", [(2, False), (4, True)],
                         ids=["e2-rgb", "e4-rgba"])
def test_kernel_split_instances(host_kernel, effort, alpha):
    """The measurement instances `uastc_pack_split`: stop 5 is the whole
    kernel (its bytes) with either group of lanes; each earlier stop writes
    a subset of the bits of the next but at the flips' stop (3), whose
    marks are measurement only; a stop outside 1..5 and a group other than
    0, 4 and 8 are refused."""
    modes, _, extra, _ = pack._effort_mode_set(effort, alpha)
    tabs = pack.pack_tables(modes, extra)
    compact, alpha0 = _drawn(effort, alpha, 300 + effort)
    want = _plain(compact, alpha0, modes, extra)
    for group in (4, 8):
        got = {stop: _kernel(host_kernel, compact, alpha0, tabs, 0, stop,
                             group) for stop in range(1, 6)}
        np.testing.assert_array_equal(got[5], want)
        for lo, hi in ((1, 2), (2, 4), (4, 5)):
            assert not (got[lo] & ~got[hi]).any()
    c = torch.from_numpy(compact)
    out = torch.zeros((len(compact), 16), dtype=torch.uint8)
    for stop, group in ((6, 0), (5, 2)):
        assert host_kernel.uastc_pack_split(
            c.data_ptr(), torch.from_numpy(alpha0).data_ptr(),
            tabs.data_ptr(), tabs.numel(), out.data_ptr(), len(compact),
            stop, group, None) != 0
