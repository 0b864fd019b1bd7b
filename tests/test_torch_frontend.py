"""The port's ETC1S frontend and compressor against the reference's, on the
CPU, on synthetic textures from `basis_universal_tpu_torch.testing.synthetic`.

64x64 runs k-means with a float32 cross term (fewer than 1024 endpoint
clusters), 256x256 with the bf16 one (2,064 clusters at q128). Every file
is decoded by the reference's host decoder with all CRCs checked.

The port spells out XLA-CPU's float32 order in every operator that ranks
(`ops/xla_order.py`), the perceptual metric's included, draws the random
fill of empty k-means seeds as jax.random does (`ops/threefry.py`) and
orders the refine shortlist's ties as the reference's `approx_min_k` does
(`etc1s_encode._refine_shortlist`), so the files are the reference's
bytes.

Both compressors must run the same host back end (`same_host_backend`).
"""

import dataclasses
import time

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from basis_universal_tpu import compressor as ref_compressor
from basis_universal_tpu import native as ref_native
from basis_universal_tpu.codecs.etc1s import frontend as ref_frontend
from basis_universal_tpu.ops.etc1 import image_to_blocks
from basis_universal_tpu_torch import compressor, native
from basis_universal_tpu_torch.codecs.etc1s import frontend
from basis_universal_tpu_torch.testing.checks import etc1s_psnr
from basis_universal_tpu_torch.testing.synthetic import synthetic_texture

PSNR_TOL_DB = 0.05
SIZE_TOL = 0.015


def _load_reference_native():
    """Whether the reference's native library is loaded, after loading it
    again where an earlier attempt failed.

    The reference builds that library under one fixed temporary name in a
    cache shared by every process; when several test workers start with an
    empty cache and build it at once, a worker whose rename loses the race
    keeps the failure for the rest of its life. Once the winner's library is
    in place, a second attempt loads it."""
    for _ in range(30):
        if ref_native.available():
            return True
        ref_native._tried = False        # forget the lost race, load again
        time.sleep(1.0)
    return False


@pytest.fixture(autouse=True, scope="module")
def same_host_backend():
    """Hold the port to the reference's native host path, not to its
    fallback: without its native library the reference runs the device
    neighbour-copy RDO instead of the native one, and its files differ (the
    256x256 image: -0.08 dB against the port). Both packages must run the
    same back end."""
    assert _load_reference_native() == native.available()


def test_reference_native_loads_again_after_a_lost_build_race(monkeypatch):
    monkeypatch.setattr(ref_native, "_tried", True)     # the failure, kept
    monkeypatch.setattr(ref_native, "_lib", None)
    assert not ref_native.available()
    assert _load_reference_native() == native.available()


def _drift(port_out, ref_out, img):
    """(PSNR port - ref in dB, size port / ref - 1) of one texture."""
    p_port = etc1s_psnr(port_out.basis_data, img)
    p_ref = etc1s_psnr(ref_out.basis_data, img)
    assert p_port > 20.0
    print(f"PSNR port {p_port:.4f} ref {p_ref:.4f} dB; size "
          f"{len(port_out.basis_data)} vs {len(ref_out.basis_data)} B")
    return p_port - p_ref, len(port_out.basis_data) / len(ref_out.basis_data) - 1


def _same_bytes(port_out, ref_out, img):
    _drift(port_out, ref_out, img)
    assert port_out.basis_data == ref_out.basis_data
    assert port_out.ktx2_data == ref_out.ktx2_data


def test_seed_fill_is_the_references_draw():
    """Empty k-means seeds take the training vectors jax.random.choice
    draws from PRNGKey(seed) (`ops/threefry.py`)."""
    from basis_universal_tpu_torch.ops import threefry

    for seed in (0, 1, 63, 2**31 - 1, -5):
        for n, k in ((256, 144), (24576, 2416), (7, 300), (100003, 17)):
            want = np.asarray(jax.random.choice(jax.random.PRNGKey(seed),
                                                jnp.arange(n), (k,)))
            np.testing.assert_array_equal(
                threefry.choice_indices(seed, n, k), want)


def test_a_batchs_fills_drawn_at_once_are_each_seeds_draw():
    """`fill_indices` over a batch's seeds (one pass of the Threefry draw)
    gives each seed's own `jax.random.choice` draw."""
    from basis_universal_tpu_torch.ops import threefry

    seeds = [0, 1, 2**31 - 1, 2**31 + 7, -5, 12345678901]
    for n, k in ((24576, 2416), (7, 300)):
        many = frontend.fill_indices(seeds, n, k)
        assert many.shape == (len(seeds), k) and many.dtype == np.int64
        for row, seed in zip(many, seeds):
            np.testing.assert_array_equal(
                row, threefry.choice_indices(seed, n, k))
        want = np.asarray(jax.random.choice(
            jax.random.PRNGKey(seeds[3]), jnp.arange(n), (k,)))
        np.testing.assert_array_equal(many[3], want)


@pytest.mark.parametrize("size", [(32, 48), (64, 64)])
@pytest.mark.parametrize("seed", [0, 2**31 + 7])
def test_frontend_impl_fed_the_host_drawn_fill(size, seed):
    """`_frontend_impl` fed the fill indices drawn on the host before the
    dispatch (`frontend.fill_indices`) gives the five outputs of the path
    that draws them inside from a seeded generator, bit for bit. At q255
    the bisecting init leaves 12 of 96 and 69 of 256 seeds empty, so the
    fill decides the codebooks: another seed's fill gives others."""
    img, _ = synthetic_texture(*size, seed=31)
    params = compressor.CompressorParams(device="cpu", quality_level=255)
    blocks = compressor._prepare_slices([img], params)[0]["blocks"]
    fp = compressor._frontend_params(params, len(blocks))
    knobs, left, up = frontend._knobs_and_neighbors(len(blocks), fp, None)
    args = (torch.as_tensor(left), torch.as_tensor(up), 1.0, 1.0)
    px = torch.as_tensor(blocks)
    gen = torch.Generator()
    gen.manual_seed(seed)
    want = frontend._frontend_impl(px, None, *args, generator=gen, **knobs)
    (idx,) = frontend.fill_indices([seed], len(blocks), knobs["num_e"])
    assert idx.dtype == np.int64 and idx.shape == (knobs["num_e"],)
    got = frontend._frontend_impl(px, torch.as_tensor(idx), *args, **knobs)
    for g, w in zip(got, want):
        assert g.dtype == w.dtype and torch.equal(g, w)
    other = frontend._frontend_impl(px, torch.as_tensor(frontend.fill_indices(
        [seed + 1], len(blocks), knobs["num_e"])[0]), *args, **knobs)
    assert not all(torch.equal(o, w) for o, w in zip(other, want))


def test_constant_tables_are_made_once_per_device():
    """`etc1s_encode.constant`: one tensor per (table, device), the tables'
    values; the frontend's palettes read the same tensor."""
    from basis_universal_tpu_torch.ops import etc1s_encode as ops
    from basis_universal_tpu_torch.ops.etc1 import ETC1_INTEN_TABLES

    for name in ops._TABLES:
        t = ops.constant(name, "cpu")
        assert ops.constant(name, torch.device("cpu")) is t
        np.testing.assert_array_equal(t.numpy(), ops._TABLES[name]())
    np.testing.assert_array_equal(ops.constant("inten", "cpu").numpy(),
                                  ETC1_INTEN_TABLES)
    assert ops.constant("inten", "cpu").dtype == torch.float32
    assert ops.constant("deltas2", "cpu").shape == (125, 3)
    assert ops.constant("gvec", "cpu").dtype == torch.float32
    made = len(ops._CONSTANTS)
    frontend._palette(torch.zeros((4, 3), dtype=torch.int32),
                      torch.arange(4, dtype=torch.int32))
    assert len(ops._CONSTANTS) == made


class _StubGraph:
    """A stand-in for `frontend._Graph` on the CPU: a 'capture' records
    its key's inputs, a 'replay' runs `_frontend_impl` eagerly on them."""

    def __init__(self, dev, inputs, thresholds, knobs):
        import threading

        self.lock, self.released = threading.Lock(), False
        self.shapes = [a.shape for a in inputs]
        self.thresholds, self.knobs, self.runs = thresholds, knobs, 0

    def run(self, inputs):
        assert not self.released        # the cache dropped it: never again
        self.runs += 1
        return frontend._frontend_impl(*(torch.as_tensor(a) for a in inputs),
                                       *self.thresholds, **self.knobs)

    def release(self):
        self.released = True


@pytest.fixture
def stub_graphs(monkeypatch):
    """The graph cache on the CPU through `_StubGraph`: (the cache, the
    textures that ran as a capture's warm-up)."""
    import collections
    import contextlib

    from basis_universal_tpu_torch.utils import telemetry

    cache, warm = collections.OrderedDict(), []

    @contextlib.contextmanager
    def side_stream(dev):
        warm.append(len(telemetry.drain()[0]))
        yield

    monkeypatch.setattr(frontend, "_GRAPHS", cache)
    monkeypatch.setattr(frontend, "_capturable", lambda dev: True)
    monkeypatch.setattr(frontend, "_Graph", _StubGraph)
    monkeypatch.setattr(frontend, "_side_stream", side_stream)
    return cache, warm


def _tiny_batch(n, blocks=16, seed=0):
    rng = np.random.default_rng(seed)
    return [rng.integers(0, 256, (blocks, 16, 3), np.uint8) for _ in range(n)]


_TINY = frontend.FrontendParams(max_endpoint_clusters=8,
                                max_selector_clusters=8, effort=1,
                                device="cpu")


def _graph_counts(run):
    """(captures, replays) counted by the recorder over run()."""
    from basis_universal_tpu_torch.utils import telemetry

    telemetry.drain()
    telemetry.record(True)
    try:
        run()
    finally:
        telemetry.record(False)
    counters = telemetry.drain()[1]
    return tuple(counters.get(f"etc1s.frontend.graph_{k}", (0, 0))[0]
                 for k in ("captures", "replays"))


def _same_outputs(got, want):
    for g, w in zip(got, want):
        for f in dataclasses.fields(frontend.FrontendOutput):
            np.testing.assert_array_equal(getattr(g, f.name),
                                          getattr(w, f.name))


def test_graph_rule_never_captures_on_the_cpu():
    """CPU tensors run eagerly: nothing is cached, nothing counted."""
    frontend.drop_graphs()
    batch = _tiny_batch(3)
    counts = _graph_counts(lambda: list(frontend.compress_batch_iter(
        batch, _TINY)))
    assert counts == (0, 0) and not frontend._GRAPHS


def test_graph_rule_captures_on_a_keys_second_texture(stub_graphs):
    """In a batch, the first texture runs eagerly as the warm-up, the
    second captures the key's graph and replays it, the rest replay; the
    outputs are the eager ones."""
    cache, warm = stub_graphs
    batch = _tiny_batch(4)
    want = [frontend.compress(b, _TINY, seed=5 + i)
            for i, b in enumerate(batch)]
    assert not cache
    got = []
    counts = _graph_counts(lambda: got.extend(frontend.compress_batch_iter(
        batch, _TINY, seed=5)))
    assert counts == (1, 3)
    assert len(warm) == 1 and len(cache) == 1
    (graph,) = cache.values()
    assert graph.runs == 3 and graph.shapes[0] == (16, 16, 3)
    assert graph.shapes[1] == (8,)                   # the fill indices
    _same_outputs(got, want)


def test_graph_rule_a_lone_compress_never_captures(stub_graphs):
    """`compress` replays a cached key only; a one-texture batch neither
    captures nor warms up."""
    cache, warm = stub_graphs
    (one,) = _tiny_batch(1)
    assert _graph_counts(lambda: frontend.compress(one, _TINY)) == (0, 0)
    assert _graph_counts(lambda: list(frontend.compress_batch_iter(
        [one], _TINY))) == (0, 0)
    assert not cache and not warm
    _graph_counts(lambda: list(frontend.compress_batch_iter(
        _tiny_batch(2), _TINY)))
    assert _graph_counts(lambda: frontend.compress(one, _TINY)) == (0, 1)


def test_graph_cache_drops_the_least_recently_used_past_four_keys(
        stub_graphs):
    """Five keys (block counts) captured in turn keep four; a key used
    again is kept over one used less recently."""
    cache, _ = stub_graphs
    made = []
    for blocks in (16, 20, 24, 28):
        list(frontend.compress_batch_iter(_tiny_batch(2, blocks), _TINY))
        made.append(next(reversed(cache.values())))
    frontend.compress(_tiny_batch(1, 16)[0], _TINY)      # 16 used again
    list(frontend.compress_batch_iter(_tiny_batch(2, 32), _TINY))
    assert len(cache) == 4
    assert [g.released for g in made] == [False, True, False, False]
    assert [g.shapes[0][0] for g in cache.values()] == [24, 28, 16, 32]
    frontend.drop_graphs()
    assert not cache and all(g.released for g in made)


def test_graph_cache_under_threads(stub_graphs):
    """12 threads (more than the cores), each running two batches, six keys
    between them, through a cache of four, with a short switch interval: every
    output is the eager one, no dropped graph runs again (`_StubGraph`),
    and the cache ends with four live graphs."""
    import concurrent.futures as cf
    import sys

    cache, _ = stub_graphs
    sizes = (16, 20, 24, 28, 32, 36)
    batches = {b: _tiny_batch(2, b, seed=b) for b in sizes}
    # lone calls on an empty cache: eager
    want = {b: [frontend.compress(x, _TINY, seed=i)
                for i, x in enumerate(batches[b])] for b in sizes}
    assert not cache

    def worker(k):
        for j in range(2):
            b = sizes[(k + j) % len(sizes)]
            _same_outputs(list(frontend.compress_batch_iter(batches[b], _TINY)),
                          want[b])
        return k

    interval = sys.getswitchinterval()
    sys.setswitchinterval(1e-5)
    try:
        with cf.ThreadPoolExecutor(12) as ex:
            futs = [ex.submit(worker, k) for k in range(12)]
            assert sorted(f.result(timeout=600) for f in futs) == list(range(12))
    finally:
        sys.setswitchinterval(interval)
    assert len(cache) == 4 and not any(g.released for g in cache.values())


@pytest.mark.parametrize("name, key", [
    ("void (anonymous namespace)::fscan_kernel<27, false, true, false>"
     "(float const*, float const*, float const*, float*, long*, int, int, "
     "int)", "factorized_scan"),
    ("void (anonymous namespace)::fscan_kernel<1, true, false, true>"
     "(float const*)", "factorized_scan_shortlist"),
    ("void (anonymous namespace)::cross6_kernel<true>(float const*)",
     "cross6_distances"),
    ("void (anonymous namespace)::cross6_argmin_kernel<false>(float const*)",
     "cross6_argmin"),
    ("void (anonymous namespace)::rescore_kernel<true>(float const*)",
     "palette_errs_packed"),
    ("void (anonymous namespace)::errs_kernel(float const*)", "palette_errs"),
    ("void (anonymous namespace)::xla_reduce_kernel64<(anonymous namespace)"
     "::Order)1>(float const*)", "xla_reduce"),
    ("void (anonymous namespace)::xla_fma_kernel_rows(float const*)",
     "xla_fma"),
    ("bisect_round_kernel<16, 6, 8>(float const*)", "bisect_round"),
    ("void at::native::vectorized_elementwise_kernel<4, "
     "at::native::FillFunctor<float>, std::array<char*, 1ul> >(int)", None),
    ("Memcpy HtoD (Pinned -> Device)", None)])
def test_trace_kernel_names_read_as_wrapper_launches(name, key):
    """The device trace's kernel names, demangled, count under the wrapper
    that launches the kernel (`testing/launches.py`); PyTorch's own
    kernels and copies under none."""
    from basis_universal_tpu_torch.testing.launches import kernel_launch_name

    assert kernel_launch_name(name) == key


def test_trace_kernel_name_of_the_port_that_no_wrapper_reads_raises():
    from basis_universal_tpu_torch.testing.launches import kernel_launch_name

    with pytest.raises(ValueError, match="no wrapper"):
        kernel_launch_name("void (anonymous namespace)::xla_fma_kernel16()")


def test_a_launch_recorded_into_a_graph_is_not_counted(monkeypatch):
    """`cuda_etc1s.LAUNCHES` counts a wrapper's launch that runs now, and
    not one that a stream capturing a CUDA graph records."""
    from basis_universal_tpu_torch.ops import cuda_etc1s as ck

    ck.reset_launch_counts()
    ck._launched("bisect_round")
    monkeypatch.setattr(torch.cuda, "is_initialized", lambda: True)
    capturing = [False]
    monkeypatch.setattr(torch.cuda, "is_current_stream_capturing",
                        lambda: capturing[0])
    ck._launched("bisect_round")
    capturing[0] = True
    ck._launched("bisect_round")
    assert {k: v for k, v in ck.LAUNCHES.items() if v} == {"bisect_round": 2}
    ck.reset_launch_counts()


def test_mesh_draws_each_devices_fills_in_one_pass(monkeypatch):
    """`compress_batch_sharded` draws each device's fill indices in one
    `fill_indices` call over its textures' seeds, and its files are
    `compress_batch`'s."""
    from basis_universal_tpu_torch.parallel import mesh

    imgs = [synthetic_texture(32, 48, seed=50 + i)[0] for i in range(5)]
    params = compressor.CompressorParams(device="cpu", seed=7)
    draws, draw = [], frontend.fill_indices

    def counted(seeds, *args):
        draws.append(list(seeds))
        return draw(seeds, *args)

    monkeypatch.setattr(frontend, "fill_indices", counted)
    got = mesh.compress_batch_sharded(imgs, params, ["cpu", "cpu"])
    assert sorted(draws) == [[7, 9, 11], [8, 10]]
    want = compressor.compress_batch(imgs, params)
    assert [o.basis_data for o in got] == [o.basis_data for o in want]


@pytest.mark.parametrize("alpha", [False, True])
def test_compress_matches_reference_64(alpha):
    """64x64 (256 blocks, 144 endpoint clusters): the reference's bytes, six
    seeds each. (One exact endpoint tie broken the other way moves a
    bisecting split and so the whole small codebook: the port spells out
    XLA-CPU's float32 order in every operator that ranks.)"""
    for seed in range(60, 66):
        img, _ = synthetic_texture(64, 64, seed=seed, alpha=alpha)
        ref = ref_compressor.compress(img, ref_compressor.CompressorParams())
        port = compressor.compress(img, compressor.CompressorParams(
            device="cpu"))
        assert len(port.slice_endpoints) == (2 if alpha else 1)
        _same_bytes(port, ref, img)


def test_compress_matches_reference_256():
    """256x256: 2,064 endpoint clusters, the bf16 k-means cross term."""
    img, _ = synthetic_texture(256, 256, seed=256)
    port = compressor.compress(img, compressor.CompressorParams(device="cpu"))
    ref = ref_compressor.compress(img, ref_compressor.CompressorParams())
    _same_bytes(port, ref, img)


@pytest.mark.parametrize("quality,effort,perceptual", [
    (16, 0, False), (255, 0, False), (255, 3, False), (128, 6, True)])
def test_compress_matches_reference_across_settings(quality, effort,
                                                    perceptual):
    """Other codebook sizes, efforts (radius 2 and a 32-wide shortlist at
    effort 6, three refine passes at 3) and the perceptual metric, on one
    128x128 RGBA texture: the reference's bytes. The perceptual metric's
    transforms, moments and sums round as XLA-CPU rounds the reference's
    (`etc1s_encode.perceptual_transform`, `_block_moments`)."""
    img, _ = synthetic_texture(128, 128, seed=77, alpha=True)
    port = compressor.compress(img, compressor.CompressorParams(
        device="cpu", quality_level=quality, effort=effort,
        perceptual_metric=perceptual))
    ref = ref_compressor.compress(img, ref_compressor.CompressorParams(
        quality_level=quality, effort=effort, perceptual_metric=perceptual))
    _same_bytes(port, ref, img)


@pytest.mark.parametrize("size,seed,quality,effort", [
    ((64, 64), 3, 128, 1), ((128, 128), 5, 128, 1), ((128, 128), 6, 80, 2),
    ((84, 100), 8, 255, 3), ((84, 100), 8, 128, 1), ((256, 256), 256, 128, 1)])
def test_compress_perceptual_matches_reference(size, seed, quality, effort):
    """The perceptual metric at other sizes, qualities and efforts: the
    reference's bytes. The 84x100 texture's 525 blocks give candidate-base
    arrays whose row count is no multiple of 8, and q 80 at 128x128 and
    both 84x100 settings an odd codebook (397, 525, 279 entries), so the
    transform's trailing rows (`etc1s_encode._perc_rows`) run in the scan,
    the cluster scan and the refine's rescore."""
    img, _ = synthetic_texture(*size, seed=seed)
    port = compressor.compress(img, compressor.CompressorParams(
        device="cpu", quality_level=quality, effort=effort,
        perceptual_metric=True))
    ref = ref_compressor.compress(img, ref_compressor.CompressorParams(
        quality_level=quality, effort=effort, perceptual_metric=True))
    _same_bytes(port, ref, img)


def test_compress_batch_matches_reference_and_is_deterministic():
    """Two 128x128 textures (528 endpoint clusters): the reference's bytes,
    each. In image 5 one block's refine shortlist has several entries at
    equal 6-D distance about its 16th place; the reference's `approx_min_k`
    (an unstable sort on the CPU) keeps the ones its `std::sort` leaves
    there, and so does the port (`_refine_shortlist`): a stable sort kept
    others, and that image differed. Two runs give the same bytes."""
    imgs = [synthetic_texture(128, 128, seed=s)[0] for s in (5, 6)]
    params = compressor.CompressorParams(device="cpu")
    port = compressor.compress_batch(imgs, params)
    ref = ref_compressor.compress_batch(imgs, ref_compressor.CompressorParams())
    for p, r, img in zip(port, ref, imgs):
        _same_bytes(p, r, img)
    again = compressor.compress_batch(imgs, params)
    assert [o.basis_data for o in again] == [o.basis_data for o in port]


def test_compress_batch_mixed_sizes_runs_per_image():
    imgs = [synthetic_texture(64, 64, seed=1)[0],
            synthetic_texture(40, 48, seed=2)[0]]
    params = compressor.CompressorParams(device="cpu")
    batch = compressor.compress_batch(imgs, params)
    single = [compressor.compress(i, params) for i in imgs]
    assert [o.basis_data for o in batch] == [o.basis_data for o in single]
    assert etc1s_psnr(batch[1].basis_data, imgs[1]) > 20.0


def test_compress_with_global_codebooks_fed_the_reference_codebook():
    img, _ = synthetic_texture(64, 64, seed=9)
    blocks = image_to_blocks(img).reshape(-1, 16, 3)
    fe = ref_frontend.compress(blocks.astype(np.float32),
                               ref_frontend.FrontendParams(
                                   max_endpoint_clusters=100,
                                   max_selector_clusters=100, effort=1,
                                   perceptual=False))
    cb = (fe.endpoint_color5, fe.endpoint_inten5, fe.selectors)
    got = frontend.compress_with_global_codebooks(blocks, *cb, effort=1,
                                                  perceptual=False,
                                                  device="cpu")
    want = ref_frontend.compress_with_global_codebooks(blocks, *cb, effort=1,
                                                       perceptual=False)
    np.testing.assert_array_equal(got.endpoint_color5, want.endpoint_color5)
    np.testing.assert_array_equal(got.selectors, want.selectors)
    # assignments may differ only between entries the block scores equally
    pal = np.clip(((cb[0].astype(np.int32) << 3) | (cb[0] >> 2))[:, None, :]
                  + ref_frontend.ETC1_INTEN_TABLES[cb[1]][:, :, None], 0, 255)

    def err(e, s):
        p = pal[e]                                           # (B,4,3)
        sel = cb[2][s]                                       # (B,16)
        rec = np.take_along_axis(p, sel[..., None].astype(np.int64), 1)
        return ((blocks.astype(np.float64) - rec) ** 2).sum((1, 2))

    e_g = err(got.block_endpoints, got.block_selectors)
    e_w = err(want.block_endpoints, want.block_selectors)
    np.testing.assert_allclose(e_g, e_w, rtol=1e-5)
    ties = (got.block_endpoints != want.block_endpoints).sum()
    print(f"global codebooks: endpoint ties {ties}/{len(blocks)}")
    # through the compressor: a valid file with the shared-codebook flag
    params = compressor.CompressorParams(device="cpu", global_codebooks=cb)
    ref_params = ref_compressor.CompressorParams(global_codebooks=cb)
    out = compressor.compress(img, params)
    if ties == 0:
        assert out.basis_data == ref_compressor.compress(img, ref_params).basis_data


def test_frontend_ranks_without_tf32_and_restores_the_setting(monkeypatch):
    seen = []
    port_kmeans = frontend.ops.kmeans

    def kmeans(*args, **kwargs):
        seen.append(torch.backends.cuda.matmul.allow_tf32)
        return port_kmeans(*args, **kwargs)

    monkeypatch.setattr(frontend.ops, "kmeans", kmeans)
    monkeypatch.setattr(torch.backends.cuda.matmul, "allow_tf32", True)
    img, _ = synthetic_texture(16, 16, seed=1)
    compressor.compress(img, compressor.CompressorParams(device="cpu"))
    assert seen == [False]
    assert torch.backends.cuda.matmul.allow_tf32 is True


def test_init_selector_patterns_matches_reference():
    rng = np.random.default_rng(3)
    distinct = rng.integers(0, 4, (20, 16))
    distinct[0, 15] = 3                     # a key with the int32 sign bit set
    opt_sel = distinct[rng.integers(0, 20, 300)]
    for num_s in (12, 30):                  # 30 > 20 distinct: empty groups
        got = frontend._init_selector_patterns(torch.from_numpy(opt_sel), num_s)
        want = ref_frontend._init_selector_patterns(jnp.asarray(opt_sel), num_s)
        np.testing.assert_array_equal(got.numpy(), np.asarray(want))
        assert got.dtype == torch.int32


def test_host_helpers_match_reference():
    for q in (1, 16, 50, 100, 128, 129, 160, 192, 223, 255):
        for blocks in (16, 256, 4096, 24576, 98304):
            assert (compressor.etc1s_quality_to_clusters(q, blocks)
                    == ref_compressor.etc1s_quality_to_clusters(q, blocks))
        for effort in (0, 1, 2, 3, 6):
            kw = dict(quality_level=q, effort=effort)
            assert (compressor._rdo_thresholds(compressor.CompressorParams(**kw))
                    == ref_compressor._rdo_thresholds(
                        ref_compressor.CompressorParams(**kw)))
    for effort in range(11):
        assert frontend._effort_knobs(effort) == ref_frontend._effort_knobs(effort)
        fp = frontend.FrontendParams(max_endpoint_clusters=5000,
                                     max_selector_clusters=900, effort=effort)
        rp = ref_frontend.FrontendParams(max_endpoint_clusters=5000,
                                         max_selector_clusters=900,
                                         effort=effort)
        for b in (300, 24576):
            knobs, _, _ = frontend._knobs_and_neighbors(b, fp, None)
            rknobs, _, _ = ref_frontend._knobs_and_neighbors(b, rp, None)
            rknobs.pop("init_sub")
            assert knobs == rknobs

    img = synthetic_texture(20, 36, seed=4, alpha=True)[0]
    p = compressor.CompressorParams(device="cpu", mip_gen=True)
    rp = ref_compressor.CompressorParams(mip_gen=True)
    sl, rsl = compressor._prepare_slices([img], p), ref_compressor._prepare_slices([img], rp)
    assert len(sl) == len(rsl)
    for a, b in zip(sl, rsl):
        np.testing.assert_array_equal(a["blocks"], b["blocks"])
        assert {k: a[k] for k in a if k != "blocks"} == \
            {k: b[k] for k in a if k != "blocks"}
    for x, y in zip(compressor._slice_neighbors(sl),
                    ref_compressor._slice_neighbors(rsl)):
        np.testing.assert_array_equal(x, y)
    assert compressor._ktx2_layout(p, sl) == ref_compressor._ktx2_layout(rp, rsl)

    rng = np.random.default_rng(5)
    args = (rng.integers(0, 30, 200), rng.integers(0, 32, (30, 3)),
            rng.integers(0, 8, 30), rng.integers(0, 4, (25, 16)),
            rng.integers(0, 25, 200), 30, 25)
    got, want = frontend._host_finalize(*args), ref_frontend._host_finalize(*args)
    for f in ("endpoint_color5", "endpoint_inten5", "selectors",
              "block_endpoints", "block_selectors"):
        np.testing.assert_array_equal(getattr(got, f), getattr(want, f))
