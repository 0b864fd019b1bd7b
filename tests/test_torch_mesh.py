"""The port's multi-device helpers (`basis_universal_tpu_torch/parallel/
mesh.py`) on the CPU, with the CPU named twice as the two devices.

Inputs: synthetic textures made from a seed (`testing/synthetic.py`).
`compress_batch_sharded` must give `compress_batch`'s bytes; the
block-sharded frontend step must give the reference's step (JAX, one CPU
device) and a one-device run of itself: centroids within rtol 1e-5 (the
partial segment sums are added per shard, in another order), assignments
equal except where two centroids are equally near.
"""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from basis_universal_tpu.parallel import mesh as ref_mesh
from basis_universal_tpu_torch import compressor
from basis_universal_tpu_torch.ops.etc1 import image_to_blocks
from basis_universal_tpu_torch.parallel import mesh
from basis_universal_tpu_torch.testing.synthetic import synthetic_texture

RTOL = 1e-5


@pytest.fixture(autouse=True)
def _one_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def test_texture_batch_mesh_resolves_devices():
    assert mesh.texture_batch_mesh(["cpu", "cpu"]) == [torch.device("cpu")] * 2
    with pytest.raises(ValueError):
        mesh.texture_batch_mesh([])
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="CUDA"):
            mesh.texture_batch_mesh()
        with pytest.raises(RuntimeError, match="CUDA"):
            mesh.texture_batch_mesh(["cuda:0"])


@pytest.mark.parametrize("alpha", [False, True])
def test_compress_batch_sharded_gives_compress_batchs_bytes(alpha):
    imgs = [synthetic_texture(32, 48, seed=100 + i, alpha=alpha)[0]
            for i in range(3)]
    params = compressor.CompressorParams(quality_level=64, effort=1,
                                         device="cpu")
    want = compressor.compress_batch(imgs, params)
    got = mesh.compress_batch_sharded(imgs, params, ["cpu", "cpu"])
    assert [o.basis_data for o in got] == [o.basis_data for o in want]
    assert [o.ktx2_data for o in got] == [o.ktx2_data for o in want]


def test_compress_batch_sharded_rejects_mixed_shapes():
    imgs = [synthetic_texture(32, 48, seed=1)[0],
            synthetic_texture(16, 16, seed=2)[0]]
    with pytest.raises(ValueError, match="uniform"):
        mesh.compress_batch_sharded(
            imgs, compressor.CompressorParams(device="cpu"), ["cpu", "cpu"])


def _near_ties_only(vecs, centroids, a, b):
    """Where assignments a and b differ, both centroids are equally near."""
    differ = a != b
    d = ((vecs[:, None, :].double() - centroids[None].double()) ** 2).sum(-1)
    rows = torch.arange(len(vecs))
    np.testing.assert_allclose(d[rows, a][differ], d[rows, b][differ],
                               rtol=1e-5, atol=1e-9)
    return int(differ.sum())


@pytest.mark.parametrize("num_clusters", [16, 64])
def test_block_sharded_step_matches_one_device_and_the_reference(
        num_clusters):
    img = synthetic_texture(64, 64, seed=7)[0]
    blocks = image_to_blocks(img).reshape(-1, 16, 3).astype(np.float32)
    c2, a2 = mesh.shard_blocks_frontend_step(["cpu", "cpu"], num_clusters)(
        blocks)
    c1, a1 = mesh.shard_blocks_frontend_step(["cpu"], num_clusters)(blocks)
    np.testing.assert_allclose(c2.numpy(), c1.numpy(), rtol=RTOL, atol=1e-7)

    step = ref_mesh.shard_blocks_frontend_step(
        ref_mesh.texture_batch_mesh(jax.devices()[:1]), num_clusters)
    rc, ra = (torch.from_numpy(np.array(x))
              for x in step(jnp.asarray(blocks)))
    np.testing.assert_allclose(c1.numpy(), rc.numpy(), rtol=RTOL, atol=1e-7)
    enc = mesh.ops.encode_blocks(torch.from_numpy(blocks), radius=1)
    vecs = torch.cat([enc["low"], enc["high"]], -1) * (1.0 / 255.0)
    ties = _near_ties_only(vecs, c1, a2, a1) + _near_ties_only(
        vecs, c1, a1, ra.long())
    print(f"block-sharded step, {num_clusters} clusters: {ties} "
          "assignments differ, all at ties")


def test_graft_forward_matches_the_reference_entry():
    """`chip_smoke.graft_forward`, the port's twin of the forward step of
    `__graft_entry__.entry()`, on its 1,024 seeded blocks: the same cluster
    assignments and selector patterns, errors within rtol 1e-5."""
    import importlib.util
    import pathlib

    import __graft_entry__

    path = pathlib.Path(__file__).resolve().parent.parent / "chip_smoke.py"
    spec = importlib.util.spec_from_file_location("chip_smoke", path)
    smoke = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(smoke)
    forward, (blocks,) = __graft_entry__.entry()
    want = [np.asarray(x) for x in jax.jit(forward)(jnp.asarray(blocks))]
    got = [x.numpy() for x in smoke.graft_forward(torch.from_numpy(blocks))]
    np.testing.assert_array_equal(got[0], want[0])
    np.testing.assert_array_equal(got[1], want[1])
    np.testing.assert_allclose(got[2], want[2], rtol=RTOL)
