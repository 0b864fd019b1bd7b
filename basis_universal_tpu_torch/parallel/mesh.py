"""Multi-device parallelism: texture-batch data parallelism over a list of
torch devices.

Counterpart of `basis_universal_tpu/parallel/mesh.py`. The reference's
scaling story is basis_parallel_compress(), one CPU job per texture
(encoder/basisu_comp.cpp:5466); per-texture codebook state is independent,
so a batch of textures spreads over devices with no collective at all
(`compress_batch_sharded`). Only when one texture's blocks are split across
devices does k-means need a reduction (`shard_blocks_frontend_step`): the
JAX package leaves it to XLA's all-reduce, this port adds the partial sums
on the first device in shard order.

A "mesh" here is a plain list of `torch.device`s (`texture_batch_mesh`).
Every function runs with the same device named twice (["cpu", "cpu"] in the
tests, ["cuda:0", "cuda:0"] on a machine with one card), which drives the
same code as two cards would; a run over more than one card needs a machine
that has them.
"""

import concurrent.futures as cf

import numpy as np
import torch

from ..codecs.etc1s.frontend import resolve_device
from ..ops import etc1s_encode as ops


def texture_batch_mesh(devices=None):
    """The devices to spread work over, as a list of `torch.device`:
    `devices` resolved (a CUDA device without CUDA raises), or by default
    every visible CUDA device; raises where there is none."""
    if devices is None:
        if not torch.cuda.is_available() or torch.cuda.device_count() == 0:
            raise RuntimeError("texture_batch_mesh: no CUDA device is "
                               "visible; pass devices=[...] to name others")
        devices = [f"cuda:{i}" for i in range(torch.cuda.device_count())]
    out = [resolve_device(d) for d in devices]
    if not out:
        raise ValueError("texture_batch_mesh: no devices given")
    return out


def shard_blocks_frontend_step(devices, num_clusters: int, iters: int = 2):
    """One ETC1S frontend iteration with a SINGLE texture's blocks split
    across `devices` (block parallel): per-block encode, then k-means over
    the blocks' 6-D endpoint vectors, seeded with the first `num_clusters`
    vectors as the reference's step is.

    Shard j holds a contiguous run of the blocks and runs `encode_blocks`
    and its share of every k-means iteration (the assignment and the
    segment sums of its members) on devices[j]. The partial sums are added
    on devices[0] in shard order, the explicit stand-in for XLA's
    all-reduce, and the new centroids are sent back to every shard.

    Returns fn(blocks (B,16,3) float32, numpy or tensor) -> (centroids
    (C, 6) float32, assignment (B,) int64), both on devices[0].
    """
    devs = texture_batch_mesh(devices)
    home = devs[0]

    def step(blocks):
        px = torch.as_tensor(np.asarray(blocks, dtype=np.float32)
                             if not isinstance(blocks, torch.Tensor)
                             else blocks).float()
        shards = [s.to(d).contiguous()
                  for s, d in zip(torch.tensor_split(px, len(devs)), devs)]
        vecs = []
        with ops.exact_matmuls():
            for s in shards:
                enc = ops.encode_blocks(s, radius=1)
                vecs.append(torch.cat([enc["low"], enc["high"]], -1)
                            * (1.0 / 255.0))
            centroids = torch.cat([v.to(home) for v in vecs])[:num_clusters]
            assigns = None
            for _ in range(iters):
                assigns, sums, cnts = [], 0, 0
                for v in vecs:
                    a = ops.kmeans_assign(v, centroids.to(v.device),
                                          num_clusters)
                    w = torch.ones(v.shape[0], dtype=torch.float32,
                                   device=v.device)
                    sums = sums + ops.segment_sum(v, a, num_clusters).to(home)
                    cnts = cnts + ops.segment_sum(w, a, num_clusters).to(home)
                    assigns.append(a)
                centroids = ops.kmeans_update(sums, cnts, centroids)
        return centroids, torch.cat([a.to(home) for a in assigns])

    return step


def compress_batch_sharded(images, params, devices):
    """`compressor.compress_batch` (ETC1S) with the textures spread over
    `devices`: texture i's frontend runs on devices[i % len(devices)] with
    seed + i, one worker thread per device, and the host assembles each
    texture's entropy streams as it finishes. The output is byte-identical
    to `compress_batch` on a device of the same kind (the same device
    program per texture)."""
    from .. import compressor as C
    from ..codecs.etc1s import frontend as F

    devs = texture_batch_mesh(devices)
    per_image = [C._prepare_slices([img], params) for img in images]
    shapes = {tuple((s["num_blocks_x"] * s["num_blocks_y"], s["alpha"])
                    for s in sl) for sl in per_image}
    if len(shapes) != 1:
        raise ValueError("sharded batch requires uniform image shapes")
    total_blocks = sum(s["blocks"].shape[0] for s in per_image[0])
    fp = C._frontend_params(params, total_blocks)
    nbrs = [C._slice_neighbors(sl) for sl in per_image]
    knobs, _, _ = F._knobs_and_neighbors(total_blocks, fp, nbrs[0])

    def run_device(j):
        """The textures of device j, one after another (from the second on,
        replays of one captured graph on a card, as in `compress_batch`)."""
        mine = range(j, len(images), len(devs))
        fills = F.fill_indices([params.seed + i for i in mine], total_blocks,
                               knobs["num_e"])
        return [(i, F._run_one(
                    np.concatenate([s["blocks"] for s in per_image[i]]), fp,
                    knobs, np.asarray(nbrs[i][0]), np.asarray(nbrs[i][1]),
                    fill, devs[j], texture=i, capture=k > 0,
                    warm_up=k == 0 and len(mine) > 1))
                for k, (i, fill) in enumerate(zip(mine, fills))]

    fes = [None] * len(images)
    # TF32 stays off across every worker: each frontend's exact_matmuls()
    # then restores False, whatever order the threads leave it in
    with ops.exact_matmuls(), cf.ThreadPoolExecutor(len(devs)) as ex:
        for fut in [ex.submit(run_device, j) for j in range(len(devs))]:
            for i, fe in fut.result():
                fes[i] = fe
    with cf.ThreadPoolExecutor(8) as ex:
        futs = [ex.submit(C._assemble, sl, fe, params)
                for sl, fe in zip(per_image, fes)]
        return [f.result() for f in futs]
