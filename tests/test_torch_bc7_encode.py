"""The port's BC7 search (`codecs/bc7/encode.py`) against the reference's on
the CPU: the same numpy-seeded blocks go through each device function and
its JAX counterpart, through `encode_blocks` block for block, and through
the packers byte for byte; a lossless XUBC7 stream of the port's blocks
decodes to them.

The reference runs under `jax.jit`, as its search runs: XLA's CPU compiler
contracts multiply-adds and orders sums by the loop it builds, so a
function's last bits depend on what is compiled with it. `_solve_cell` is
therefore compiled as the search compiles it (the partition table a traced
argument, or the all-ones mask a constant).

Tolerances: float outputs agree to rtol 1e-5 (measured: the same bits);
codes, pbits, partitions and selectors are equal; `encode_blocks` gives the
reference's blocks, every one, in every case (measured share 1.0).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from basis_universal_tpu.codecs.bc7 import encode as ref
from basis_universal_tpu_torch.codecs.bc7 import encode as port
from basis_universal_tpu_torch.codecs.bc7 import xbc7_decode, xbc7_encode
from basis_universal_tpu_torch.ops.etc1 import image_to_blocks
from basis_universal_tpu_torch.ops.gpu_unpack import unpack_bc7
from basis_universal_tpu_torch.testing.synthetic import synthetic_texture

N = 256
RTOL = 1e-5


@pytest.fixture(autouse=True)
def _one_thread():
    """The search is thousands of small operators: with one intra-op thread
    it runs as fast as with many, and does not fight the other test
    workers for cores."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _blocks(kind: str, seed: int = 1) -> np.ndarray:
    """(256, 16, 4) uint8 blocks: a synthetic texture without or with alpha,
    solid colours (every level and partition ties), or noise."""
    rng = np.random.default_rng(seed)
    if kind == "solid":
        px = np.repeat(rng.integers(0, 256, (N, 1, 4), dtype=np.uint8), 16, 1)
        px[: N // 2, :, 3] = 255
        return px
    if kind == "noise":
        return rng.integers(0, 256, (N, 16, 4), dtype=np.uint8)
    img, _ = synthetic_texture(64, 64, seed=seed, alpha=(kind == "rgba"))
    if img.shape[-1] == 3:
        img = np.concatenate(
            [img, np.full(img.shape[:2] + (1,), 255, np.uint8)], -1)
    return np.ascontiguousarray(image_to_blocks(img).reshape(-1, 16, 4)[:N])


def _t(x):
    return torch.as_tensor(np.array(x))


def _leaves(tree, out):
    if isinstance(tree, (tuple, list)):
        for v in tree:
            _leaves(v, out)
    else:
        out.append(np.asarray(tree.numpy() if isinstance(tree, torch.Tensor)
                              else tree))
    return out


def _hold(mine, theirs):
    """Leaf by leaf: floats to RTOL, integers equal."""
    a, b = _leaves(mine, []), _leaves(theirs, [])
    assert len(a) == len(b)
    for x, y in zip(a, b):
        assert x.shape == y.shape
        if y.dtype.kind == "f":
            # absolute floor: endpoints live on 0..255, weights on 0..1
            np.testing.assert_allclose(x, y, rtol=RTOL,
                                       atol=RTOL * max(1.0, float(np.abs(y).max())))
        else:
            np.testing.assert_array_equal(x, y)


def _cell_inputs(chans: int, masked: bool):
    """Pixels and mask of one solve: all 64 two-subset partitions of each
    block (px (N,1,16,C), mask (N,64,16)) or the whole block."""
    px = _blocks("rgba")[..., :chans].astype(np.float32)
    if not masked:
        return px, np.ones((N, 16), np.float32)
    mask = np.broadcast_to((ref._PARTITION2 == 1).astype(np.float32)[None],
                           (N, 64, 16)).copy()
    return px[:, None], mask


_CELLS = [(3, True), (4, True), (4, False), (3, False), (1, False)]
_CELL_IDS = ["rgb-partitions", "rgba-partitions", "rgba-block", "rgb-block",
             "alpha-block"]


@pytest.mark.parametrize("chans,masked", _CELLS, ids=_CELL_IDS)
def test_principal_dir(chans, masked):
    px, mask = _cell_inputs(chans, masked)
    _hold(port._principal_dir(_t(px), _t(mask)),
          jax.jit(ref._principal_dir)(px, mask))


@pytest.mark.parametrize("chans,masked", _CELLS, ids=_CELL_IDS)
def test_project_t_and_ls_endpoints(chans, masked):
    px, mask = _cell_inputs(chans, masked)
    lo, hi, _ = jax.jit(lambda p, m: ref._solve_cell(p, m, 3))(px, mask)
    lo, hi = np.asarray(lo), np.asarray(hi)
    t_ref = np.asarray(jax.jit(ref._project_t)(px, mask, lo, hi))
    _hold(port._project_t(_t(px), _t(mask), _t(lo), _t(hi)), t_ref)
    _hold(port._ls_endpoints(_t(px), _t(mask), _t(t_ref)),
          jax.jit(ref._ls_endpoints)(px, mask, t_ref))


@pytest.mark.parametrize("nbits", [2, 3, 4])
@pytest.mark.parametrize("chans,masked", _CELLS, ids=_CELL_IDS)
def test_solve_cell(chans, masked, nbits):
    px, mask = _cell_inputs(chans, masked)
    if masked:
        def solve(p, parts):
            m = (parts == 1).astype(p.dtype)[None]
            m = jnp.broadcast_to(m, (p.shape[0],) + m.shape[1:])
            return ref._solve_cell(p, m, nbits)
        theirs = jax.jit(solve)(px, ref._PARTITION2)
    else:
        theirs = jax.jit(lambda p: ref._solve_cell(
            p, jnp.ones(p.shape[:-1], p.dtype), nbits))(px)
    _hold(port._solve_cell(_t(px), _t(mask), nbits), theirs)


@pytest.mark.parametrize("bits,pbit", [(5, None), (7, None), (8, None),
                                       (4, 0), (5, 1), (6, 1), (7, 0),
                                       (7, 1)])
def test_quant_channel(bits, pbit):
    # every 1/8 step of 0..255: the whole numbers of the 8-bit cases sit on
    # rounding ties, which both round half to even
    v = np.arange(0, 255 * 8 + 1, dtype=np.float32) / 8.0
    pb = None if pbit is None else np.full(v.shape, pbit, np.int32)
    theirs = jax.jit(lambda x: ref._quant_channel(
        x, bits, None if pbit is None else jnp.asarray(pb)))(v)
    _hold(port._quant_channel(_t(v), bits, pbit), theirs)


@pytest.mark.parametrize("nbits", [2, 3, 4])
def test_interp(nbits):
    rng = np.random.default_rng(nbits)
    lo = rng.integers(0, 256, (N, 1, 4)).astype(np.int32)
    hi = rng.integers(0, 256, (N, 1, 4)).astype(np.int32)
    wtab = {2: ref._W2, 3: ref._W3, 4: ref._W4}[nbits]
    sel = np.arange(1 << nbits)
    theirs = ref._interp(jnp.asarray(lo), jnp.asarray(hi), jnp.asarray(sel),
                         jnp.asarray(wtab))
    mine = port._interp(_t(lo), _t(hi), _t(sel), _t(wtab.astype(np.int64)))
    _hold(mine, theirs)


@pytest.mark.parametrize("pbit_mode,cbits,nbits", [
    ("none", 5, 2), ("shared", 6, 3), ("per", 5, 2), ("per", 7, 2)])
def test_quant_cell(pbit_mode, cbits, nbits):
    """The same float endpoints (the reference's) through both: codes,
    pbits, selectors and the exact integer errors are equal."""
    px, mask = _cell_inputs(3, True)
    lo, hi, _ = jax.jit(lambda p, m: ref._solve_cell(p, m, nbits))(px, mask)
    wtab = {2: ref._W2, 3: ref._W3}[nbits]
    theirs = jax.jit(lambda p, m, l, h: ref._quant_cell(
        p, m, l, h, None, cbits, nbits, jnp.asarray(wtab), pbit_mode, 3,
        jnp.asarray([0.5, 1.0, 0.25])))(px, mask, lo, hi)
    mine = port._quant_cell(
        _t(px), _t(mask), _t(lo), _t(hi), None, cbits, nbits,
        _t(wtab.astype(np.int64)), pbit_mode, 3,
        torch.tensor([0.5, 1.0, 0.25]))
    _hold(mine, theirs)


def test_search_single_subset():
    px = _blocks("rgba").astype(np.float32)
    cw = np.ones(4, np.float32)
    theirs = jax.jit(lambda p: ref._search_single_subset(
        p, 7, None, 4, jnp.asarray(ref._W4), "per", jnp.asarray(cw)))(px)
    mine = port._search_single_subset(
        _t(px), 7, None, 4, _t(ref._W4.astype(np.int64)), "per", _t(cw))
    _hold(mine, theirs)


@pytest.mark.parametrize("nsub,parts,cbits,nbits,pbit_mode,chans", [
    (2, 64, 6, 3, "shared", 3),     # mode 1
    (2, 16, 6, 3, "shared", 3),     # mode 1 at effort 1
    (2, 64, 5, 2, "per", 4),        # mode 7
    (3, 16, 4, 3, "per", 3),        # mode 0
    (3, 64, 5, 2, "none", 3),       # mode 2
    (2, 64, 7, 2, "per", 3),        # mode 3
], ids=["mode1", "mode1-16", "mode7", "mode0", "mode2", "mode3"])
def test_search_n_subset(nsub, parts, cbits, nbits, pbit_mode, chans):
    px = _blocks("rgba")[..., :chans].astype(np.float32)
    table = (ref._PARTITION2 if nsub == 2 else ref._PARTITION3)[:parts]
    wtab = {2: ref._W2, 3: ref._W3}[nbits]
    cw = np.ones(chans, np.float32)
    if nsub == 2:
        ref_fn = lambda p, t: ref._search_two_subset(
            p, t, cbits, nbits, jnp.asarray(wtab), pbit_mode,
            jnp.asarray(cw), chans)
        mine = port._search_two_subset(
            _t(px), _t(table.astype(np.int64)), cbits, nbits,
            _t(wtab.astype(np.int64)), pbit_mode, _t(cw), chans)
    else:
        ref_fn = lambda p, t: ref._search_n_subset(
            p, t, 3, cbits, nbits, jnp.asarray(wtab), pbit_mode,
            jnp.asarray(cw), chans)
        mine = port._search_n_subset(
            _t(px), _t(table.astype(np.int64)), 3, cbits, nbits,
            _t(wtab.astype(np.int64)), pbit_mode, _t(cw), chans)
    theirs = jax.jit(ref_fn)(px, table)
    _hold(mine, theirs)


_ENCODE_CASES = (
    [(e, kind, None, False) for e in (0, 1, 2)
     for kind in ("rgb", "rgba", "solid", "noise")]
    + [(e, "rgba", None, True) for e in (1, 2)]
    + [(2, kind, (5, 6), p) for kind in ("rgb", "rgba") for p in (False, True)]
    + [(2, "rgba", (m,), False) for m in range(8)])


def _case_id(case):
    e, kind, modes, perceptual = case
    m = "all" if modes is None else "m" + "".join(map(str, modes))
    return f"e{e}-{kind}-{m}" + ("-perceptual" if perceptual else "")


def _sse(blocks, px):
    d = unpack_bc7(blocks).astype(np.float64) - px.astype(np.float64)
    return (d * d).sum((1, 2))


@pytest.mark.parametrize("case", _ENCODE_CASES, ids=_case_id)
def test_encode_blocks_block_for_block(case):
    effort, kind, modes, perceptual = case
    px = _blocks(kind, seed=3)
    theirs = ref.encode_blocks(px, effort=effort, perceptual=perceptual,
                               modes=modes)
    mine = port.encode_blocks(px, effort=effort, perceptual=perceptual,
                              modes=modes, device="cpu")
    assert mine.shape == theirs.shape == (N, 16) and mine.dtype == np.uint8
    np.testing.assert_array_equal(mine, theirs)
    assert np.isfinite(_sse(mine, px)).all()


def test_mode_restriction_is_respected():
    px = _blocks("rgba", seed=4)
    for m in range(8):
        blocks = port.encode_blocks(px, effort=2, modes=(m,), device="cpu")
        # the mode is the position of the lowest set bit of byte 0
        first = blocks[:, 0].astype(np.int32)
        assert ((first & -first) == (1 << m)).all(), m


def test_chunking_changes_no_bit(monkeypatch):
    px = _blocks("rgba", seed=5)
    whole = port.encode_blocks(px, effort=2, device="cpu")
    monkeypatch.setattr(port, "_CHUNK", 100)             # 100 + 100 + 56
    np.testing.assert_array_equal(
        port.encode_blocks(px, effort=2, device="cpu"), whole)


def test_cuda_is_the_default_device_and_raises_when_absent(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        port.encode_blocks(_blocks("rgb")[:4])


def _packer_args(mode: int, rng):
    n = 64
    r = lambda hi, *shape: rng.integers(0, hi, (n,) + shape).astype(np.int32)
    if mode == 6:
        return (r(128, 1, 4), r(128, 1, 4), r(2, 1), r(2, 1), r(16, 16))
    if mode == 1:
        pb = r(2, 2)
        return (r(64), r(64, 2, 3), r(64, 2, 3), pb, pb.copy(), r(8, 16))
    if mode == 7:
        return (r(64), r(32, 2, 4), r(32, 2, 4), r(2, 2), r(2, 2), r(4, 16))
    if mode == 0:
        return (r(16), r(16, 3, 3), r(16, 3, 3), r(2, 3), r(2, 3), r(8, 16))
    if mode == 2:
        return (r(64), r(32, 3, 3), r(32, 3, 3), r(4, 16))
    if mode == 3:
        return (r(64), r(128, 2, 3), r(128, 2, 3), r(2, 2), r(2, 2), r(4, 16))
    if mode == 4:
        isel = r(2).astype(np.int64)
        csel = np.where(isel[:, None] == 1, r(8, 16), r(4, 16))
        asel = np.where(isel[:, None] == 1, r(4, 16), r(8, 16))
        return (isel, r(32, 1, 3), r(32, 1, 3), r(64), r(64), csel, asel)
    return (r(128, 1, 3), r(128, 1, 3), r(256), r(256), r(4, 16), r(4, 16))


@pytest.mark.parametrize("mode", range(8))
def test_packers_are_byte_equal(mode):
    args = _packer_args(mode, np.random.default_rng(mode))
    mine = getattr(port, f"pack_mode{mode}")(*[a.copy() for a in args])
    theirs = getattr(ref, f"pack_mode{mode}")(*[a.copy() for a in args])
    np.testing.assert_array_equal(mine, theirs)
    first = mine[:, 0].astype(np.int32)
    assert ((first & -first) == (1 << mode)).all()


@pytest.mark.parametrize("kind,effort", [("rgb", 2), ("rgba", 2), ("rgba", 1)])
def test_lossless_xubc7_stream_returns_the_blocks(kind, effort):
    pytest.importorskip("zstandard")
    img, _ = synthetic_texture(48, 40, seed=6, alpha=(kind == "rgba"))
    if img.shape[-1] == 3:
        img = np.concatenate(
            [img, np.full(img.shape[:2] + (1,), 255, np.uint8)], -1)
    px = image_to_blocks(img).reshape(-1, 16, 4)
    bc7 = port.encode_blocks(px, effort=effort, device="cpu")
    stream = xbc7_encode.encode_blocks(bc7, 48, 40)
    _, back = xbc7_decode.decode_bc7(stream)
    np.testing.assert_array_equal(np.asarray(back).reshape(-1, 16), bc7)
