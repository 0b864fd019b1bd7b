"""The port's CUDA kernels against their plain PyTorch versions, on a CUDA
card (marked `cuda`; each test skips where there is none). This file
imports no jax; `tests/conftest.py` does, so where jax is not installed run
it without the conftest:

    python -m pytest --noconftest -p no:cacheprovider -m cuda tests/test_torch_cuda.py -q

Tolerances are those of `test_torch_kernels.py`: floats rtol 1e-5, the
scan's plus 1e-6 of `checks.scan_term_magnitude` (the terms its formula
cancels); indices equal except at ties. Encodes on the card are repeated
and must give the same bytes (the segment sums are deterministic).
"""

import faulthandler

import numpy as np
import pytest
import torch

from basis_universal_tpu_torch.ops import cuda_etc1s as ck

RTOL = 1e-5
B = 300


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    ck.reset_launch_counts()
    return torch.device("cuda")


def _blocks(n, seed):
    rng = np.random.default_rng(seed)
    px = rng.integers(0, 256, (n, 1, 3)) + rng.integers(-24, 25, (n, 16, 3))
    px[: n // 6] = rng.integers(0, 256, (n // 6, 16, 3))
    return torch.as_tensor(np.clip(px, 0, 255), dtype=torch.float32)


def _close(got, want, mag=0.0):
    got, want = got.double().cpu(), want.double().cpu()
    err = (got - want).abs()
    bound = RTOL * want.abs() + 1e-6 * mag
    assert torch.all(err <= bound), f"worst err/bound {(err / bound).max()}"


@pytest.mark.cuda
@pytest.mark.parametrize("perceptual", [False, True])
@pytest.mark.parametrize("radius", [0, 1, 2])
def test_factorized_scan_on_card(cuda, radius, perceptual):
    """The gray-axis sums: the plain version's bits with whole-numbered
    pixels in RGB; with the perceptual metric, 3 x the sums (the error's
    share) within the scan's tolerance."""
    from basis_universal_tpu_torch.testing.checks import scan_term_magnitude

    px = _blocks(B, 41 + radius)
    base5 = torch.as_tensor(np.random.default_rng(1).integers(0, 32, (B, 3)),
                            dtype=torch.float32)
    for base in (None, base5):
        kw = dict(radius=radius, perceptual=perceptual)
        got = ck.factorized_scan(px.to(cuda),
                                 None if base is None else base.to(cuda), **kw)
        want = ck.factorized_scan_reference(px, base, **kw)
        if perceptual:
            _close(3.0 * got, 3.0 * want, scan_term_magnitude(px, base, **kw))
        else:
            assert torch.equal(got.cpu(), want)
    assert ck.LAUNCHES["factorized_scan"] == 2


def _planted(n, seed):
    """_blocks with every 7th block saturated (each channel at 0..3 or
    252..255): clipped deltas coincide there, so columns tie exactly, also
    across the 16th place."""
    px = _blocks(n, seed)
    rng = np.random.default_rng(seed + 1)
    sat = torch.arange(n) % 7 == 3
    low = torch.as_tensor(rng.integers(0, 4, (n, 16, 3)), dtype=torch.float32)
    side = torch.as_tensor(rng.integers(0, 2, (n, 1, 3)), dtype=torch.bool)
    px[sat] = torch.where(side, 255.0 - low, low)[sat]
    return px


@pytest.mark.cuda
@pytest.mark.parametrize("perceptual", [False, True])
@pytest.mark.parametrize("radius", [0, 1, 2])
def test_factorized_scan_shortlist_is_the_full_scans_shortlist_on_card(
        cuda, radius, perceptual):
    """The fused kernel's columns equal `_shortlist` of the plain errors on
    the card (`factorized_scan_errors_reference`, exact with whole-numbered
    pixels in RGB, as the kernel is), ties at the k-th place included, at
    one block, 300, a ragged 24,575 and the main path's 24,576, with and
    without a cluster base; with the perceptual metric a column may differ
    only where the plain errors tie within the scan's tolerance."""
    from basis_universal_tpu_torch.ops.etc1s_encode import _shortlist
    from basis_universal_tpu_torch.testing.checks import scan_term_magnitude

    kw = dict(radius=radius, perceptual=perceptual)
    k = min(16, (2 * radius + 1) ** 3 * 8)
    tied = 0
    for b in (1, 300, 24575, 24576):
        px = _planted(b, 50 + b % 7).to(cuda)
        base5 = torch.as_tensor(np.random.default_rng(b).integers(0, 32, (b, 3)),
                                dtype=torch.float32).to(cuda)
        for base in (None, base5):
            got = ck.factorized_scan_shortlist(px, base, **kw)
            full = ck.factorized_scan_errors_reference(px, base, **kw)
            assert got.dtype == torch.int64 and got.shape == (b, k)
            want = _shortlist(full, k)
            if perceptual:
                rows = torch.arange(b, device=cuda)[:, None]
                mag = scan_term_magnitude(px, base, **kw)
                a, w = full[rows, got], full[rows, want]
                tol = 2 * (RTOL * w.abs() + 1e-6 * mag[rows, want])
                assert torch.all((a - w).abs()[got != want]
                                 <= tol[got != want])
            else:
                assert torch.equal(got, want)
            if k < full.shape[1]:
                srt = torch.sort(full, dim=-1).values
                tied += int((srt[:, k - 1] == srt[:, k]).sum())
    assert radius == 0 or tied > 0
    print(f"shortlist r{radius} perceptual={perceptual}: {tied} rows tie "
          "at the k-th place")


@pytest.mark.cuda
def test_scan_and_rescore_are_deterministic_on_card(cuda):
    px = _planted(24576, 11).to(cuda)
    packed = torch.as_tensor(
        np.random.default_rng(12).integers(0, 1 << 18, (24576, 16)),
        dtype=torch.int32).to(cuda)
    for radius in (0, 1, 2):
        for fn in (ck.factorized_scan, ck.factorized_scan_shortlist):
            first = fn(px, radius=radius)
            assert torch.equal(fn(px, radius=radius), first)
    for perceptual in (False, True):
        first = ck.palette_errs_packed(px, packed, perceptual)
        assert torch.equal(ck.palette_errs_packed(px, packed, perceptual),
                           first)


def _packed(rng, k):
    c5 = rng.integers(0, 32, (B, k, 3))
    return torch.as_tensor(c5[..., 0] | (c5[..., 1] << 5) | (c5[..., 2] << 10)
                           | (rng.integers(0, 8, (B, k)) << 15),
                           dtype=torch.int32)


@pytest.mark.cuda
@pytest.mark.parametrize("k", [16, 8])
@pytest.mark.parametrize("perceptual", [False, True])
def test_palette_errs_packed_on_card(cuda, perceptual, k):
    px = _blocks(B, 43)
    packed = _packed(np.random.default_rng(7), k)
    got = ck.palette_errs_packed(px.to(cuda), packed.to(cuda), perceptual)
    _close(got, ck.palette_errs_packed_reference(px, packed, perceptual))
    assert ck.LAUNCHES["palette_errs_packed"] == 1


@pytest.mark.cuda
@pytest.mark.parametrize("perceptual", [False, True])
def test_palette_errs_on_card(cuda, perceptual):
    from basis_universal_tpu_torch.ops import etc1s_encode as ops

    px = _blocks(B, 44)
    packed = _packed(np.random.default_rng(8), 16)
    c5 = torch.stack([packed & 31, (packed >> 5) & 31, (packed >> 10) & 31], -1)
    tabs = torch.as_tensor(ck.ETC1_INTEN_TABLES, dtype=torch.float32)
    pal = torch.clamp(ops.expand5(c5).float()[:, :, None, :]
                      + tabs[((packed >> 15) & 7).long()][..., None], 0, 255)
    if perceptual:
        px, pal = ops.perceptual_transform(px), ops.perceptual_transform(pal)
    got = ck.palette_errs(px.to(cuda), pal.contiguous().to(cuda))
    want = ck.palette_errs_reference(px, pal)
    if perceptual:
        _close(got, want)
    else:
        # integer pixels and palettes: every partial sum is exact
        assert torch.equal(got.cpu(), want)
    assert ck.LAUNCHES["palette_errs"] == 1


@pytest.mark.cuda
def test_segment_sum_is_deterministic_on_card(cuda):
    from basis_universal_tpu_torch.ops import etc1s_encode as ops

    gen = torch.Generator().manual_seed(5)
    data = torch.randn((24576, 43), generator=gen) * 1000.0
    ids = torch.randint(0, 2416, (24576,), generator=gen)
    ids[:4000] = 7                                  # one large segment
    first = ops.segment_sum(data.to(cuda), ids.to(cuda), 2500)
    for _ in range(3):
        assert torch.equal(ops.segment_sum(data.to(cuda), ids.to(cuda), 2500),
                           first)
    cpu = ops.segment_sum(data, ids, 2500)
    scale = data.abs().max() * 4000
    assert torch.all((first.cpu() - cpu).abs() <= RTOL * (cpu.abs() + scale))
    print("segment_sum card == cpu bit for bit:", torch.equal(first.cpu(), cpu))


@pytest.mark.cuda
def test_uastc_search_on_card_matches_cpu(cuda):
    """The search spells out every reduction that can round
    (`xla_order`), so the card gives the CPU's blocks, every one."""
    from basis_universal_tpu_torch.codecs.uastc import encode, pack

    rng = np.random.default_rng(9)
    px = np.concatenate([_blocks(B - 20, 45).numpy(),
                         np.full((20, 16, 3), 255.0, np.float32)])
    alpha = rng.integers(0, 256, (B, 16, 1)).astype(np.float32)
    px = np.concatenate([px, alpha], -1)
    px[B // 2:, :, 3] = 255.0
    modes, ls_iters, extra, topk = pack._effort_mode_set(3, True)
    got = encode._search(torch.as_tensor(px).to(cuda), modes, ls_iters, extra,
                         topk)
    assert ck.LAUNCHES["factorized_scan_shortlist"] == 1
    assert ck.LAUNCHES["factorized_scan"] == 0
    assert ck.LAUNCHES["palette_errs_packed"] == 1
    want = encode._search(torch.as_tensor(px), modes, ls_iters, extra, topk)
    got_b = pack._pack_from_compact(got, px, modes, extra)
    want_b = pack._pack_from_compact(want, px, modes, extra)
    np.testing.assert_array_equal(got_b, want_b)


@pytest.fixture
def limit():
    """Ends the process, with every thread's traceback, if the test runs
    past its time limit: a selector launch whose mbarrier phases went wrong
    would otherwise wait for ever (the kernel traps after 10 s of waiting,
    which fails the launch; this covers the rest)."""
    faulthandler.dump_traceback_later(120, exit=True)
    yield
    faulthandler.cancel_dump_traceback_later()


def _selector_inputs(b, s, seed, cuda):
    gen = torch.Generator().manual_seed(seed)
    dists = torch.rand((b, 16, 4), generator=gen) * 5000.0
    pats = torch.randint(0, 4, (s, 16), generator=gen, dtype=torch.int32)
    return dists.to(cuda), pats.to(cuda)


def _check_selector(best, val, dists, pats, s):
    """min_err within rtol of the plain version's; an index may differ only
    where the plain error of the kernel's pattern ties the plain minimum."""
    pb, pv = ck.find_best_selector_patterns_reference(dists, pats, s)
    _close(val, pv)
    d = dists.to(torch.bfloat16).float()
    err_of = d.gather(2, pats[best.long()].long()[..., None])[..., 0].sum(-1)
    differ = best != pb
    assert torch.all((err_of - pv).abs()[differ] <= RTOL * pv.abs()[differ])
    assert torch.all((best >= 0) & (best < s))
    return int(differ.sum())


@pytest.mark.cuda
@pytest.mark.parametrize("b", [1, 24575, 24576])
@pytest.mark.parametrize("s", [1, 7, 2731, 16128])
def test_find_best_selector_patterns_on_card(cuda, limit, s, b):
    """The tensor-core kernel against its plain version (on the card, TF32
    off) from one pattern up to MAX_SELECTOR_CLUSTERS, at one block, a
    ragged 24,575 and the main path's 24,576."""
    dists, pats = _selector_inputs(b, s, s + b, cuda)
    best, val = ck.find_best_selector_patterns(dists, pats, s)
    assert best.dtype == torch.int32 and val.dtype == torch.float32
    assert ck.LAUNCHES["find_best_selector_patterns"] == 1
    ties = _check_selector(best, val, dists, pats, s)
    print(f"selector B={b} S={s}: {ties} index ties")


@pytest.mark.cuda
@pytest.mark.parametrize("b", [25343, 25344, 25345])
@pytest.mark.parametrize("s", [127, 128, 129])
def test_selector_around_the_tile_and_the_wave_on_card(cuda, limit, s, b):
    """S around the kernel's tile of 128 patterns (the last tile full, one
    short, one pattern into a new tile) and B around one wave of 192-row
    CTAs on 132 SMs (25,344 rows): one launch a call, the plain version's
    result up to ties."""
    dists, pats = _selector_inputs(b, s, 7 * s + b, cuda)
    best, val = ck.find_best_selector_patterns(dists, pats, s)
    torch.cuda.synchronize()
    assert ck.LAUNCHES["find_best_selector_patterns"] == 1
    ties = _check_selector(best, val, dists, pats, s)
    print(f"selector B={b} S={s}: {ties} index ties")


@pytest.mark.cuda
@pytest.mark.parametrize("s", [7, 2731])
def test_selector_rows_without_a_finite_error_on_card(cuda, limit, s):
    """A row of +inf distances and a row with one NaN have no finite error
    (0 x inf and 0 x NaN are NaN in every product): the kernel returns
    pattern 0 and +inf there, as an argmin that skips NaN would, and the
    plain version's result on every other row."""
    dists, pats = _selector_inputs(1000, s, s, cuda)
    dists[3] = float("inf")
    dists[500, 7, 2] = float("nan")
    best, val = ck.find_best_selector_patterns(dists, pats, s)
    torch.cuda.synchronize()
    assert ck.LAUNCHES["find_best_selector_patterns"] == 1
    for row in (3, 500):
        assert int(best[row]) == 0 and float(val[row]) == float("inf")
    keep = torch.ones(1000, dtype=torch.bool, device=cuda)
    keep[[3, 500]] = False
    _check_selector(best[keep], val[keep], dists[keep], pats, s)


@pytest.mark.cuda
@pytest.mark.parametrize("s", [7, 2731])
def test_selector_negative_distances_on_card(cuda, limit, s):
    """Warps whose rows hold a negative distance fold with float minima
    (the unsigned-integer order of the others holds for errors of +0 and
    more only): rows of negative, mixed and -0.0 distances beside rows of
    positive ones, the plain version's result up to ties."""
    dists, pats = _selector_inputs(3000, s, 11 * s, cuda)
    dists[:1000] -= 2500.0
    dists[1000:1100] = -0.0
    best, val = ck.find_best_selector_patterns(dists, pats, s)
    torch.cuda.synchronize()
    assert ck.LAUNCHES["find_best_selector_patterns"] == 1
    ties = _check_selector(best, val, dists, pats, s)
    print(f"selector negative distances S={s}: {ties} index ties")


@pytest.mark.cuda
@pytest.mark.parametrize("s", [7, 2731])
def test_selector_exact_ties_go_to_the_lowest_index_on_card(cuda, limit, s):
    """Small integer distances make every sum exact, so equal errors are
    exact ties, and duplicated patterns tie everywhere: the kernel must
    return the plain version's (the first) index and value exactly."""
    rng = np.random.default_rng(s)
    b = 24576
    dists = torch.as_tensor(rng.integers(0, 4, (b, 16, 4)),
                            dtype=torch.float32).to(cuda)
    m = -(-s // 2)                      # patterns m.. repeat patterns 0..
    pats = rng.integers(0, 4, (m, 16))[np.arange(s) % m]
    pats = torch.as_tensor(pats, dtype=torch.int32).to(cuda)
    best, val = ck.find_best_selector_patterns(dists, pats, s)
    pb, pv = ck.find_best_selector_patterns_reference(dists, pats, s)
    err = (dists.reshape(b, 64).cpu().double()
           @ torch.nn.functional.one_hot(pats.long().cpu(), 4).reshape(s, 64)
           .double().T)
    first = err.argmin(1)                               # numpy rule: first
    assert torch.equal(err.min(1).values.float(), pv.cpu())
    assert torch.equal(pb.cpu().long(), first)
    assert torch.equal(best.cpu().long(), first)
    assert torch.equal(val.cpu(), pv.cpu())
    assert bool((best < m).all())                       # never a later twin


@pytest.mark.cuda
def test_selector_kernel_is_deterministic_on_card(cuda, limit):
    """Repeated calls give identical outputs, as do int64 patterns and a
    distance tensor that starts off the 8-byte alignment the kernel's float2
    loads need (the wrapper copies both)."""
    dists, pats = _selector_inputs(24576, 2731, 5, cuda)
    best, val = ck.find_best_selector_patterns(dists, pats, 2731)
    for _ in range(3):
        b2, v2 = ck.find_best_selector_patterns(dists, pats, 2731)
        assert torch.equal(b2, best) and torch.equal(v2, val)
    shifted = torch.empty(dists.numel() + 1, device=cuda)[1:]
    shifted.copy_(dists.reshape(-1))
    b2, v2 = ck.find_best_selector_patterns(shifted.view(dists.shape),
                                            pats.long(), 2731)
    assert torch.equal(b2, best) and torch.equal(v2, val)


@pytest.mark.cuda
def test_compress_on_card_launches_each_kernel(cuda):
    from basis_universal_tpu_torch import compressor
    from basis_universal_tpu_torch.testing.checks import etc1s_psnr
    from basis_universal_tpu_torch.testing.synthetic import synthetic_texture

    from basis_universal_tpu_torch.codecs.etc1s import frontend

    img, _ = synthetic_texture(64, 64, seed=3)
    params = compressor.CompressorParams(device="cuda")
    out = compressor.compress(img, params)
    knobs, _, _ = frontend._knobs_and_neighbors(
        256, compressor._frontend_params(params, 256), None)
    refine, sel = knobs["refine_iters"], knobs["sel_iters"]
    # encode_blocks scans (fused with its shortlist) and rescores once; each
    # refine pass scans once, assembles its cluster errors once, rescores
    # twice and takes one distance matrix; each selector iteration and the
    # final pass search once; each k-means iteration takes one argmin; the
    # ordered sums run where the frontend spells out XLA's float32 order
    # outside those kernels (the selector distances), no fused multiply-add
    xla = {k: ck.LAUNCHES[k] for k in ("xla_fma", "xla_reduce")}
    assert xla["xla_fma"] == 0 and xla["xla_reduce"] > 0
    assert {k: v for k, v in ck.LAUNCHES.items() if k not in xla} == {
        "factorized_scan": refine, "factorized_scan_shortlist": 1,
        "palette_errs_packed": 1 + 2 * refine, "palette_errs": 0,
        "find_best_selector_patterns": sel + 1,
        "cross6_argmin": knobs["kmeans_iters"], "cross6_distances": refine,
        "cluster_scan_assemble": refine,
        "bisect_rows": 1,
        "bisect_round": int(np.ceil(np.log2(knobs["num_e"]))),
        "xla_cpu_min_k": refine,
        "uastc_line_fit": 0, "uastc_mode_trial": 0, "uastc_subset_trial": 0,
        "uastc_dualplane_trial": 0, "uastc_pack": 0}
    cpu = compressor.compress(img, compressor.CompressorParams(device="cpu"))
    assert out.basis_data == cpu.basis_data
    assert etc1s_psnr(out.basis_data, img) > 25.0
    # deterministic segment sums: the card gives the same file every time
    assert compressor.compress(img, params).basis_data == out.basis_data


@pytest.mark.cuda
def test_uastc_compress_on_card(cuda, monkeypatch):
    """The card's files are the CPU's, byte for byte; per image one ETC1
    hint and one `uastc_pack`, and the numpy packer never runs."""
    from basis_universal_tpu_torch import compressor
    from basis_universal_tpu_torch.codecs.uastc import pack
    from basis_universal_tpu_torch.formats.constants import BasisTexFormat
    from basis_universal_tpu_torch.testing.checks import uastc_psnr
    from basis_universal_tpu_torch.testing.synthetic import synthetic_texture

    def refuse(*args, **kw):
        raise AssertionError("the numpy packer ran")

    monkeypatch.setattr(pack, "_pack_from_compact", refuse)
    imgs = [synthetic_texture(64, 64, seed=s, alpha=s == 1)[0] for s in (0, 1)]
    kw = dict(tex_format=BasisTexFormat.UASTC_LDR_4x4, effort=2)
    outs = compressor.compress_batch(imgs, compressor.CompressorParams(
        device="cuda", **kw))
    # one ETC1 hint per image: one fused scan (radius 0) and one rescore
    # (K 8); one packing of the blocks
    assert ck.LAUNCHES["factorized_scan_shortlist"] == 2
    assert ck.LAUNCHES["factorized_scan"] == 0
    assert ck.LAUNCHES["palette_errs_packed"] == 2
    assert ck.LAUNCHES["uastc_pack"] == 2
    for img, out in zip(imgs, outs):
        cpu = compressor.compress(img, compressor.CompressorParams(
            device="cpu", **kw))
        assert out.basis_data == cpu.basis_data
        assert uastc_psnr(out.basis_data, img) > 25.0
        again = compressor.compress(img, compressor.CompressorParams(
            device="cuda", **kw))
        assert again.basis_data == out.basis_data


def _bc7_blocks_with_ties(n=512, seed=9):
    """(n, 16, 4) uint8: gradients with noise, then blocks that plant ties:
    solid colours (every palette level and partition ties), two-colour
    blocks (whole-numbered endpoints, on the 7+1-bit rounding ties), and
    opaque and translucent halves."""
    rng = np.random.default_rng(seed)
    px = np.clip(rng.integers(0, 256, (n, 1, 4))
                 + rng.integers(-24, 25, (n, 16, 4)), 0, 255)
    q = n // 4
    px[:q] = rng.integers(0, 256, (q, 1, 4))
    two = rng.integers(0, 256, (q, 2, 4))
    pick = rng.integers(0, 2, (q, 16))
    px[q:2 * q] = two[np.arange(q)[:, None], pick]
    px[::2, :, 3] = 255
    return px.astype(np.uint8)


@pytest.mark.cuda
@pytest.mark.parametrize("perceptual", [False, True])
@pytest.mark.parametrize("effort,modes", [(1, None), (2, None), (2, (5, 6)),
                                          (2, (3,)), (2, (1, 7))])
def test_bc7_search_on_card_equals_cpu_at_planted_ties(cuda, effort, modes,
                                                       perceptual):
    """Every sum of the search is spelled out in XLA's order, so the card
    and the CPU give the same blocks, ties (first minimum) included; on the
    card those sums are the XLA-order kernels, and the search launches no
    ETC1S kernel."""
    from basis_universal_tpu_torch.codecs.bc7 import encode as bc7

    px = _bc7_blocks_with_ties()
    kw = dict(effort=effort, modes=modes, perceptual=perceptual)
    card = bc7.encode_blocks(px, device="cuda", **kw)
    np.testing.assert_array_equal(card, bc7.encode_blocks(px, device="cpu",
                                                          **kw))
    np.testing.assert_array_equal(card, bc7.encode_blocks(px, device="cuda",
                                                          **kw))
    xla = ("xla_fma", "xla_reduce")
    assert all(ck.LAUNCHES[k] > 0 for k in xla)
    assert not any(v for k, v in ck.LAUNCHES.items() if k not in xla)


@pytest.mark.cuda
def test_argmin_takes_the_first_minimum_on_card(cuda):
    x = torch.zeros((1000, 64, 16), device=cuda)
    assert int(torch.argmin(x, dim=-1).max()) == 0
    assert int(torch.argmin(x.sum(-1), dim=1).max()) == 0
    x[:, :, 5:] = -1.0
    assert bool((torch.argmin(x, dim=-1) == 5).all())


@pytest.mark.cuda
@pytest.mark.parametrize("fmt_name,kw", [
    ("ASTC_LDR_4x4", {}), ("XUASTC_LDR_4x4", dict(xuastc_syntax="arith")),
    ("ASTC_LDR_6x6", {}), ("XUASTC_LDR_6x6", dict(xuastc_syntax="arith")),
    ("UASTC_HDR_4x4", {})])
def test_new_modes_on_card_launch_counts_and_bytes(cuda, fmt_name, kw):
    """Per image level the 4x4 ASTC paths launch one fused scan (radius 0)
    and one rescore (K 8), the UASTC search's ETC1 hint, and one
    `uastc_pack`; the other modes launch no kernel. The files equal the
    CPU's, twice."""
    from basis_universal_tpu_torch import compressor
    from basis_universal_tpu_torch.formats.constants import BasisTexFormat
    from basis_universal_tpu_torch.testing.synthetic import synthetic_texture

    fmt = BasisTexFormat[fmt_name]
    if "HDR" in fmt_name:
        img = np.random.default_rng(2).uniform(0, 4, (40, 48, 3)).astype(
            np.float32)
    else:
        img = synthetic_texture(40, 48, seed=3, alpha=True)[0]
    params = dict(tex_format=fmt, effort=1, mip_gen=True,
                  mip_smallest_dimension=16, **kw)
    out = compressor.compress(img, compressor.CompressorParams(
        device="cuda", **params))
    levels = 3                                          # 40x48 .. 10x12
    want = levels if fmt_name.endswith("LDR_4x4") else 0
    assert ck.LAUNCHES["factorized_scan_shortlist"] == want
    assert ck.LAUNCHES["palette_errs_packed"] == want
    assert ck.LAUNCHES["uastc_pack"] == want
    assert ck.LAUNCHES["factorized_scan"] == 0
    assert ck.LAUNCHES["find_best_selector_patterns"] == 0
    again = compressor.compress(img, compressor.CompressorParams(
        device="cuda", **params))
    assert out.basis_data == again.basis_data
    cpu = compressor.compress(img, compressor.CompressorParams(
        device="cpu", **params))
    assert out.basis_data == cpu.basis_data


@pytest.mark.cuda
def test_metrics_on_card_match_cpu(cuda):
    from basis_universal_tpu_torch.ops import metrics

    rng = np.random.default_rng(4)
    a = rng.integers(0, 256, (96, 80, 4), dtype=np.uint8)
    b = np.clip(a.astype(np.int32) + rng.integers(-9, 10, a.shape), 0,
                255).astype(np.uint8)
    for fn in (metrics.psnr, metrics.ssim, metrics.psnr_hvs_m):
        assert fn(a, b, device="cuda") == pytest.approx(
            fn(a, b, device="cpu"), rel=1e-4)
    card, cpu = (metrics.image_metrics(a, b, device=d)
                 for d in ("cuda", "cpu"))
    assert card == pytest.approx(cpu, rel=1e-4)
    ha = rng.uniform(0, 60, (48, 40, 3)).astype(np.float32)
    hb = np.abs(ha + rng.normal(0, 0.4, ha.shape).astype(np.float32))
    card, cpu = (metrics.hdr_image_metrics(ha, hb, device=d)
                 for d in ("cuda", "cpu"))
    assert card == pytest.approx(cpu, rel=1e-2)


@pytest.mark.cuda
@pytest.mark.parametrize("radius", [0, 1, 2])
def test_factorized_scan_minterm_on_card(cuda, radius):
    """The cluster scan's gray-axis sums against per-block cluster bases:
    whole-numbered pixels give the plain version's bits."""
    px = _blocks(B, 51 + radius)
    base5 = torch.as_tensor(np.random.default_rng(2).integers(0, 32, (B, 3)),
                            dtype=torch.float32)
    got = ck.factorized_scan(px.to(cuda), base5.to(cuda), radius=radius)
    want = ck.factorized_scan_reference(px, base5, radius=radius)
    assert torch.equal(got.cpu(), want)


@pytest.mark.cuda
def test_api_on_card_gives_the_cpus_bytes(cuda):
    """UASTC, ASTC 4x4 and ETC1S through `api.Encoder` on the card: the
    CPU's bytes (every rounding that ranks is spelled out; the selector
    search's tensor-core sums of 16 bf16-exact products give the CPU's
    argmins, measured on 768x512 image 0 too); the transcoder's re-encodes
    run on the card."""
    from basis_universal_tpu_torch import api
    from basis_universal_tpu_torch.formats.constants import (
        BasisTexFormat as F, TranscoderTextureFormat as TF)
    from basis_universal_tpu_torch.testing.checks import etc1s_psnr
    from basis_universal_tpu_torch.testing.synthetic import synthetic_texture

    img = synthetic_texture(64, 96, seed=12, alpha=True)[0]
    card, cpu = api.Encoder(device="cuda"), api.Encoder(device="cpu")
    for fmt in (F.UASTC_LDR_4x4, F.ASTC_LDR_4x4):
        assert card.compress(img, fmt, 100, 2, api.BasisFlags.SRGB) == \
            cpu.compress(img, fmt, 100, 2, api.BasisFlags.SRGB)
    a = card.compress(img, F.ETC1S, 50, 1, api.BasisFlags.SRGB)
    b = cpu.compress(img, F.ETC1S, 50, 1, api.BasisFlags.SRGB)
    assert a == b
    assert etc1s_psnr(a, img) > 25.0
    data = cpu.compress(img, F.UASTC_LDR_4x4, 100, 2, api.BasisFlags.SRGB)
    ck.reset_launch_counts()
    tr = api.Transcoder(device="cuda")
    etc1 = tr.transcode_tfmt(data, TF.ETC1_RGB)
    assert ck.LAUNCHES["factorized_scan_shortlist"] == 1
    assert np.asarray(etc1).shape == (16, 24, 8)
    np.testing.assert_array_equal(tr.decode_rgba(data),
                                  api.Transcoder(device="cpu").decode_rgba(
                                      data))


@pytest.mark.cuda
def test_mesh_on_card(cuda):
    """`parallel.mesh` with the one card named twice."""
    from basis_universal_tpu_torch import compressor
    from basis_universal_tpu_torch.parallel import mesh
    from basis_universal_tpu_torch.testing.synthetic import synthetic_texture

    assert mesh.texture_batch_mesh()[0] == torch.device("cuda:0")
    imgs = [synthetic_texture(48, 64, seed=20 + i)[0] for i in range(3)]
    params = compressor.CompressorParams(quality_level=64, effort=1,
                                         device="cuda")
    got = mesh.compress_batch_sharded(imgs, params, ["cuda:0", "cuda:0"])
    want = compressor.compress_batch(imgs, params)
    assert [o.basis_data for o in got] == [o.basis_data for o in want]
    blocks = _blocks(512, 21)
    c2, a2 = mesh.shard_blocks_frontend_step(["cuda:0", "cuda:0"], 32)(blocks)
    c1, a1 = mesh.shard_blocks_frontend_step(["cpu"], 32)(blocks)
    _close(c2, c1)


@pytest.mark.cuda
@pytest.mark.parametrize("n, c", [(1, 97), (300, 64), (1000, 1025),
                                  (24575, 2400), (24576, 2416)])
def test_cross6_on_card(cuda, n, c):
    """The k-means argmin and the refine's distances, their squared norms
    (and from 1,024 centroids the argmin's bf16 operands) inside: the plain
    version's bits on the card (every rounding spelled out), at ragged row
    and tile counts and on both sides of the C mod 64 rule, the first
    index on a planted tie; one launch each."""
    rng = np.random.default_rng(n + c)
    a = torch.as_tensor(rng.uniform(0, 1, (n, 6)), dtype=torch.float32)
    cb = torch.as_tensor(rng.uniform(0, 1, (c, 6)), dtype=torch.float32)
    cb[c // 2] = cb[c // 3]
    a[0] = cb[c // 3]
    got = ck.cross6_argmin(a.to(cuda), cb.to(cuda))
    want = ck.cross6_argmin_reference(a, cb)
    assert torch.equal(got.cpu(), want)
    assert int(got[0]) == min(c // 2, c // 3)
    got = ck.cross6_distances(a.to(cuda), cb.to(cuda))
    assert torch.equal(got.cpu(), ck.cross6_distances_reference(a, cb))
    assert ck.LAUNCHES["cross6_argmin"] == 1
    assert ck.LAUNCHES["cross6_distances"] == 1


def _assemble_inputs(b_n, c_n, radius, perceptual, seed, large=False):
    """The cluster scan's inputs: whole-numbered pixels (B, 16, 3), drawn
    cluster ids (with `large`, 2/3 of the blocks in one cluster) and their
    order, fractional gray-axis terms (B, D*8), the cluster bases (D, C, 3)
    of drawn 5-bit colours and deltas, and with the perceptual metric the
    bases transformed, their levels lb (D, C) and the block moments of the
    transformed pixels, as `optimize_cluster_endpoints` makes them (on the
    CPU). Returns (mt, order, offsets, base8, lb, keyword arguments)."""
    from basis_universal_tpu_torch.ops import etc1s_encode as ops
    from basis_universal_tpu_torch.ops.xla_order import _dot

    rng = np.random.default_rng(seed)
    deltas = torch.as_tensor(ops._candidate_deltas(radius))
    d_n = deltas.shape[0]
    px = torch.as_tensor(rng.integers(0, 256, (b_n, 16, 3)),
                         dtype=torch.float32)
    ids = torch.as_tensor(rng.integers(0, c_n, b_n))
    if large:
        ids[torch.as_tensor(rng.random(b_n) < 2 / 3)] = c_n // 2
    mt = torch.as_tensor(rng.uniform(0, 4e3, (b_n, 8 * d_n)),
                         dtype=torch.float32)
    base5 = torch.as_tensor(rng.integers(0, 32, (c_n, 3)))
    base8 = ops.expand5(torch.clamp(base5[None] + deltas[:, None, :], 0,
                                    31)).float().contiguous()
    lb, kw = None, dict(pixels=px)
    if perceptual:
        base8 = ops.perceptual_transform(base8).contiguous()
        lb = _dot(base8, torch.as_tensor(ops.GVEC))
        m = ops._block_moments(ops.perceptual_transform(px),
                               torch.as_tensor(ops.GVEC))
        kw = dict(moments=(m["sum_x"], m["sum_x2"], m["sum_l"], m["sum_l2"]))
    order, offsets = ops.segment_order(ids, c_n)
    return mt, order, offsets, base8, lb, kw


@pytest.mark.cuda
@pytest.mark.parametrize("b_n,c_n,radius,perceptual,large", [
    (24576, 2416, 1, False, False), (24576, 2416, 2, False, False),
    (24576, 2416, 1, True, False), (300, 37, 1, False, False),
    (300, 37, 2, True, False), (3000, 41, 1, False, True)])
def test_cluster_scan_assemble_on_card(cuda, b_n, c_n, radius, perceptual,
                                       large):
    """The cluster scan (the clusters' sums in row order and the assembly)
    on the card gives its plain version's bits at the main path's B 24,576
    and C 2,416 with D 27, with D 125 and with the perceptual metric (the
    moments and lb given), at a ragged C, and with a cluster of 2,000
    members; one launch."""
    mt, order, offsets, base8, lb, kw = _assemble_inputs(
        b_n, c_n, radius, perceptual, c_n + radius, large)

    def on(dev):
        return {k: tuple(x.to(dev) for x in v) if isinstance(v, tuple)
                else v.to(dev) for k, v in kw.items()}

    got = ck.cluster_scan_assemble(
        mt.to(cuda), order.to(cuda), offsets.to(cuda), base8.to(cuda),
        None if lb is None else lb.to(cuda), **on(cuda))
    want = ck.cluster_scan_assemble_reference(mt, order, offsets, base8, lb,
                                              **kw)
    assert torch.equal(got.cpu().view(torch.int32), want.view(torch.int32))
    assert ck.LAUNCHES["cluster_scan_assemble"] == 1
    assert ck.LAUNCHES["xla_fma"] == ck.LAUNCHES["xla_reduce"] == 0


@pytest.mark.cuda
@pytest.mark.parametrize("perceptual", [False, True])
def test_cluster_scan_on_card_is_the_cpus(cuda, perceptual):
    """`optimize_cluster_endpoints` on the card gives the CPU's endpoints,
    its cluster scan (the full scan, then the clusters' sums and the
    assembly in one kernel) the CPU's errors bit for bit."""
    from basis_universal_tpu_torch.ops import etc1s_encode as ops

    px = _blocks(3000, 77)
    rng = np.random.default_rng(78)
    ids = torch.as_tensor(rng.integers(0, 300, 3000))
    means = torch.as_tensor(rng.uniform(0, 255, (300, 3)), dtype=torch.float32)
    seen = {}
    scan = ops._cluster_scan

    def kept(*args, **kw):
        out = scan(*args, **kw)
        seen[out.device.type] = out.cpu()
        return out

    ops._cluster_scan = kept
    try:
        want = ops.optimize_cluster_endpoints(px, ids, means, 300,
                                              perceptual=perceptual)
        got = ops.optimize_cluster_endpoints(px.to(cuda), ids.to(cuda),
                                             means.to(cuda), 300,
                                             perceptual=perceptual)
    finally:
        ops._cluster_scan = scan
    assert torch.equal(seen["cuda"], seen["cpu"])
    for g, w in zip(got, want):
        assert torch.equal(g.cpu(), w)
    assert ck.LAUNCHES["cluster_scan_assemble"] == 1
    if not perceptual:
        assert ck.LAUNCHES["xla_fma"] == ck.LAUNCHES["xla_reduce"] == 0


@pytest.mark.cuda
@pytest.mark.parametrize("rows,n,levels,zeros", [
    (300, 17, 3, False), (300, 17, 3, True), (4096, 2416, 3, False),
    (4096, 2416, 40, False), (4096, 2416, 2000, False), (1024, 2416, 3, True)])
def test_xla_cpu_min_k_on_card(cuda, rows, n, levels, zeros):
    """The refine shortlist's kernel gives the columns of libstdc++'s
    `std::sort` on the host (the definition of `approx_min_k`'s order on
    XLA-CPU), bit for bit, on tie-heavy rows, signed zeros included."""
    rng = np.random.default_rng(rows + n + levels)
    if zeros:
        d = rng.integers(-2, 3, (rows, n)).astype(np.float32)
        z = d == 0
        d[z] = np.where(rng.random(z.sum()) < 0.5, -0.0, 0.0)
    else:
        d = rng.integers(0, levels, (rows, n)).astype(np.float32)
    d = torch.as_tensor(d)
    ks = [k for k in (2, 16, 32) if k <= n]
    for k in ks:
        got = ck.xla_cpu_min_k(d.to(cuda), k)
        want = ck.xla_cpu_min_k_reference(d, k, mode="std_sort")
        assert torch.equal(got.cpu(), want)
    assert ck.LAUNCHES["xla_cpu_min_k"] == len(ks)
    # the heap fallback, reached by a low depth limit: the host's steps
    part = d[:256]
    for cap in (0, 1, 3):
        assert torch.equal(
            ck.xla_cpu_min_k(part.to(cuda), 16, depth_cap=cap).cpu(),
            ck.xla_cpu_min_k_reference(part, 16, depth_cap=cap))


@pytest.mark.cuda
def test_xla_cpu_min_k_long_rows_on_card(cuda):
    """Rows too long for shared memory sort in global scratch, alike, k up
    to 32 and the heap fallback included."""
    rng = np.random.default_rng(9000)
    d = torch.as_tensor(rng.integers(0, 5, (64, 9000)).astype(np.float32))
    for k in (2, 16, 32):
        got = ck.xla_cpu_min_k(d.to(cuda), k)
        assert torch.equal(got.cpu(),
                           ck.xla_cpu_min_k_reference(d, k, mode="std_sort"))
    assert torch.equal(ck.xla_cpu_min_k(d.to(cuda), 16, depth_cap=3).cpu(),
                       ck.xla_cpu_min_k_reference(d, 16, depth_cap=3))


@pytest.mark.cuda
@pytest.mark.parametrize("n,c", [(4096, 2416), (4096, 2400), (1000, 97),
                                 (1000, 1025), (300, 64), (300, 17),
                                 (256, 6000), (256, 8192), (64, 8193)])
def test_refine_shortlist_on_card(cuda, n, c):
    """The refine's shortlist on the card, `cross6_distances` then
    `xla_cpu_min_k`, gives the plain distances' bits and the columns of
    `std::sort` of them on the host, on every row, with whole-numbered
    centroid components so that rows tie, at C on both sides of the C mod
    64 rule and past the longest row sorted in shared memory, k 2 to
    32."""
    rng = np.random.default_rng(n + c)
    a = torch.as_tensor(rng.integers(0, 4, (n, 6)) / 4.0, dtype=torch.float32)
    cb = torch.as_tensor(rng.integers(0, 3, (c, 6)) / 4.0,
                         dtype=torch.float32)
    d6 = ck.cross6_distances(a.to(cuda), cb.to(cuda))
    plain = ck.cross6_distances_reference(a, cb)
    assert torch.equal(d6.cpu(), plain)
    ks = [k for k in (2, 16, 32) if k <= c]
    for k in ks:
        assert torch.equal(ck.xla_cpu_min_k(d6, k).cpu(),
                           ck.xla_cpu_min_k_reference(plain, k,
                                                      mode="std_sort"))
    assert ck.LAUNCHES["cross6_distances"] == 1
    assert ck.LAUNCHES["xla_cpu_min_k"] == len(ks)


@pytest.mark.cuda
def test_xla_order_kernels_on_card(cuda):
    """`_fma` and the ordered sums launch their kernels on the card and give
    the plain versions' bits: contiguous, broadcast, strided and transposed
    operands, Python-float and integer operands, every order, and a
    reduced axis first, in the middle and last."""
    from basis_universal_tpu_torch.ops import xla_order as xo

    rng = np.random.default_rng(77)

    def t(*shape):
        return torch.as_tensor(rng.normal(0, 10, shape), dtype=torch.float32)

    a, b, c = t(64, 33, 5), t(33, 1), t(5)
    cases = [(a, b, c), (a, 257.0, 32.0), (a[:, ::2], t(17, 5), 0.5),
             (a.transpose(0, 2), t(5, 1, 64), t(1)),
             (a, torch.arange(5, dtype=torch.int32), c)]
    for x, y, z in cases:
        dev = [v.to(cuda) if isinstance(v, torch.Tensor) else v
               for v in (x, y, z)]
        assert torch.equal(xo._fma(*dev).cpu(), xo._fma(x, y, z))
    assert ck.LAUNCHES["xla_fma"] == len(cases)
    with pytest.raises(ValueError):
        xo._fma(a.to(cuda), 0.1, 0.0)        # 0.1 is no float32 value
    for fn, k in ((xo._dot, 16), (xo._dot_mm, 3), (xo._dot_mm, 9),
                  (xo._dot_vec16, 16)):
        x, y = t(40, k, 7), t(1, k, 7)
        for dim in (1, -2):
            assert torch.equal(fn(x.to(cuda), y.to(cuda), dim).cpu(),
                               fn(x, y, dim))
        xt, yt = x.transpose(0, 1), t(k, 1, 1)
        assert torch.equal(fn(xt.to(cuda), yt.to(cuda), 0).cpu(),
                           fn(xt, yt, 0))
    for dim in (0, 1, 2):
        x = t(6, 48, 16)
        assert torch.equal(xo._sum(x.to(cuda), dim).cpu(), xo._sum(x, dim))
    ints = torch.arange(12).reshape(3, 4)
    assert torch.equal(xo._sum(ints.to(cuda), 1).cpu(), ints.sum(1))
    assert ck.LAUNCHES["xla_reduce"] == 4 * 3 + 3
    x = t(1000)
    assert torch.equal(xo._sqrt(x.abs().to(cuda)).cpu(), xo._sqrt(x.abs()))


def _bisect_inputs(kind, cuda):
    """(vecs, weights, C) of a bisecting-init case: "texture", image 0's
    endpoint vectors (the port's encode_blocks on the card); "uniform",
    24,576 whole-numbered vectors / 255; "weighted", weights other than 1;
    "duplicates", vectors drawn from 12, so splits leave clusters empty;
    "n<c", fewer vectors than clusters."""
    rng = np.random.default_rng(len(kind))
    ones = np.ones
    if kind == "texture":
        from basis_universal_tpu_torch import compressor
        from basis_universal_tpu_torch.ops import etc1s_encode as ops
        from basis_universal_tpu_torch.testing.synthetic import \
            synthetic_texture

        img, _ = synthetic_texture(512, 768, seed=0)
        blocks = compressor._prepare_slices(
            [img], compressor.CompressorParams())[0]["blocks"]
        enc = ops.encode_blocks(torch.as_tensor(
            blocks, dtype=torch.float32, device=cuda), radius=1)
        v = (torch.cat([enc["low"], enc["high"]], -1) * (1.0 / 255.0)).cpu()
        return v, torch.ones(v.shape[0]), 2416
    if kind == "uniform":
        v = rng.integers(0, 256, (24576, 6)) / np.float32(255.0)
        w, c = ones(24576), 2416
    elif kind == "weighted":
        v, w, c = rng.uniform(0, 1, (5000, 6)), rng.uniform(0.25, 4, 5000), 300
    elif kind == "duplicates":
        pool = rng.integers(0, 32, (12, 6)) / 31.0
        v, w, c = pool[rng.integers(0, 12, 3000)], ones(3000), 1024
    else:
        v, w, c = rng.uniform(0, 1, (100, 6)), ones(100), 256
    return (torch.as_tensor(v, dtype=torch.float32),
            torch.as_tensor(w, dtype=torch.float32), c)


@pytest.mark.cuda
@pytest.mark.parametrize("kind", ["texture", "uniform", "weighted",
                                  "duplicates", "n<c"])
def test_bisect_round_on_card(cuda, kind):
    """The bisecting init's rounds, one launch each, against their plain
    version on the same rows, round by round: the same member rows in the
    same order, the same offsets, the same leaf counts and means (bits),
    on the card and on the CPU; a CTA of 16 warps per cluster in the
    early rounds, of 4 in the late ones; empty clusters included."""
    from basis_universal_tpu_torch.ops import etc1s_encode as ops

    v, w, c = _bisect_inputs(kind, cuda)
    rounds = max(1, int(np.ceil(np.log2(c))))
    members, starts = ck.bisect_rows(v.to(cuda), w.to(cuda))
    for got, want in zip((members, starts), ck.bisect_rows_reference(v, w)):
        assert torch.equal(got.cpu(), want)
    for r in range(rounds):
        last = r == rounds - 1
        got = ck.bisect_round(members, starts, last=last)
        on_card = ck.bisect_round_reference(members, starts, last=last)
        on_cpu = ck.bisect_round_reference(members.cpu(), starts.cpu(),
                                           last=last)
        for g, a, b in zip(got, on_card, on_cpu):
            if g is not None:
                assert torch.equal(g, a), f"round {r}"
                assert torch.equal(g.cpu(), b), f"round {r}"
        members, starts, leaves = got
    assert ck.LAUNCHES["bisect_rows"] == 1
    assert ck.LAUNCHES["bisect_round"] == rounds
    if kind in ("texture", "duplicates", "n<c"):
        assert int((leaves[:, 0] == 0).sum()) > 0
    # the whole init on the card against the CPU
    gen = torch.Generator().manual_seed(5)
    want = ops.bisecting_init(v, w, c, generator=gen)
    got = ops.bisecting_init(v.to(cuda), w.to(cuda), c, generator=gen)
    assert torch.equal(got.cpu(), want)


@pytest.mark.cuda
@pytest.mark.parametrize("n, c", [(24576, 2416), (24575, 2400), (777, 64),
                                  (4000, 1025)])
def test_cross6_argmin_ties_on_card(cuda, n, c):
    """The k-means argmin with ties everywhere (coordinates on a coarse
    grid, every centroid present twice or more) in both summation orders
    (C mod 64 of 48, 32, 0 and 1): every index the plain version's, the
    first of the tied centroids."""
    rng = np.random.default_rng(n + c)
    a = torch.as_tensor(rng.integers(0, 5, (n, 6)) / 4.0, dtype=torch.float32)
    cb = torch.as_tensor(rng.integers(0, 5, (c, 6)) / 4.0,
                         dtype=torch.float32)
    cb[c // 2:] = cb[:c - c // 2].clone()
    q = (cb * cb).sum(-1)
    got = ck.cross6_argmin(a.to(cuda), cb.to(cuda))
    want = ck.cross6_argmin_reference(a, cb)
    assert torch.equal(got.cpu(), want)
    d = q[None, :] - 2.0 * (a @ cb.T)
    assert int((d == d.min(1, keepdim=True).values).sum(1).max()) > 1
    assert ck.LAUNCHES["cross6_argmin"] == 1


def _same_bits(got, want):
    """got (card kernel) against want (the plain version on the CPU, each
    fused multiply-add rounded once, as the kernel's): every value equal."""
    got, want = got.cpu(), want.cpu()
    assert torch.equal(got, want), \
        f"{int((got != want).sum())} of {got.numel()} values differ"


@pytest.mark.cuda
@pytest.mark.parametrize("case", [
    "1d_rows", "1d_ragged", "rows_broadcast_col", "rows_broadcast_row",
    "misaligned", "strided", "three_dims", "scalars_only_one_tensor"])
def test_xla_fma_layouts_on_card(cuda, case):
    """`xla_fma` on each layout its launcher tells apart: one contiguous
    row (the float4 path) and one of a length no multiple of 4, rows of a
    multiple of 4 with an operand broadcast along the row or a row vector
    broadcast over the rows (float4), an operand at an address off 16
    bytes, strided views, three dimensions (the fast-divmod path), and two
    scalars; the plain version's bits, and one launch each."""
    from basis_universal_tpu_torch.ops import xla_order as xo

    rng = np.random.default_rng(hash(case) % 2**32)

    def t(*shape):
        return torch.as_tensor(rng.normal(0, 10, shape), dtype=torch.float32)

    ops = {"1d_rows": (t(4096), t(4096), t(4096)),
           "1d_ragged": (t(4099), 3.0, t(4099)),
           "rows_broadcast_col": (t(300, 64), t(300, 1), 32.0),
           "rows_broadcast_row": (t(300, 64), t(1, 64), t(300, 64)),
           "misaligned": (t(4097)[1:], t(4096), t(4096)),
           "strided": (t(300, 128)[:, ::2], t(64), t(300, 1)),
           "three_dims": (t(500, 16, 3), 257.0, t(500, 1, 3)),
           "scalars_only_one_tensor": (t(77, 5), 0.5, -2.0)}[case]
    dev = [x.to(cuda) if isinstance(x, torch.Tensor) else x for x in ops]
    got = xo._fma(*dev)
    assert ck.LAUNCHES["xla_fma"] == 1
    _same_bits(got, xo.fma_reference(*ops))


@pytest.mark.cuda
@pytest.mark.parametrize("k", [1, 2, 3, 4, 5, 16])
def test_xla_dot_mm_short_axes_on_card(cuda, k):
    """`_dot_mm` below four terms is one chain, from four on four
    accumulators: the plain version's bits at K 1-5 and 16, on a
    contiguous and on a transposed operand."""
    from basis_universal_tpu_torch.ops import xla_order as xo

    rng = np.random.default_rng(k)
    x = torch.as_tensor(rng.normal(0, 3, (700, k, 5)), dtype=torch.float32)
    y = torch.as_tensor(rng.normal(0, 3, (1, k, 5)), dtype=torch.float32)
    _same_bits(xo._dot_mm(x.to(cuda), y.to(cuda), 1),
               xo._dot_mm(x, y, 1))
    xt = x.transpose(0, 1)
    _same_bits(xo._dot_mm(xt.to(cuda), y[0][:, None].to(cuda), 0),
               xo._dot_mm(xt, y[0][:, None], 0))


@pytest.mark.cuda
@pytest.mark.parametrize("case", ["1d", "wide_span", "pixels", "broadcast_b",
                                  "last_axis"])
def test_xla_reduce_layouts_on_card(cuda, case):
    """`xla_reduce` where its block stages the slices in shared memory
    (a (B, 16, 3) sum over the pixels, a dot with a broadcast operand, a
    sum over the last axis) and where the span is too wide for that (a
    column sum of a tall matrix, read in place), and a 1-dimensional sum
    to one value: the plain version's bits."""
    from basis_universal_tpu_torch.ops import xla_order as xo

    rng = np.random.default_rng(len(case))

    def t(*shape):
        return torch.as_tensor(rng.normal(0, 10, shape), dtype=torch.float32)

    if case == "1d":
        x = t(37)
        _same_bits(xo._sum(x.to(cuda), 0), xo._sum(x, 0))
    elif case == "wide_span":
        x = t(20000, 7)
        _same_bits(xo._sum(x.to(cuda), 0), xo._sum(x, 0))
    elif case == "pixels":
        x, w = t(24576, 16, 3), t(24576, 16, 1)
        _same_bits(xo._dot(w.to(cuda), x.to(cuda), 1),
                   xo._dot(w, x, 1))
        _same_bits(xo._sum(x.to(cuda), 1), xo._sum(x, 1))
    elif case == "broadcast_b":
        x, y = t(900, 16, 4), t(1, 16, 1)
        _same_bits(xo._dot_vec16(x.to(cuda), y.to(cuda), 1),
                   xo._dot_vec16(x, y, 1))
    else:
        x = t(3000, 16, 8, 3)
        _same_bits(xo._sum(x.to(cuda), -1), xo._sum(x, -1))


@pytest.mark.cuda
@pytest.mark.parametrize("case", ["fma_offsets", "fma_outputs",
                                  "reduce_offsets"])
def test_xla_order_64_bit_layouts_on_card(cuda, case):
    """Past 2^31 elements the kernels index in 64 bits (`xla_fma_kernel64`,
    `xla_reduce_kernel64`): an operand read at offsets past 2^31 (two rows
    2^31 apart in one 8.6 GB buffer), and an output of 2^31 + 8 values;
    the plain version's bits on what they compute."""
    from basis_universal_tpu_torch.ops import xla_order as xo

    rng = np.random.default_rng(31)
    n = 2 ** 31
    if case == "fma_outputs":
        a = torch.tensor([1.5], device=cuda)
        got = xo._fma(a.expand(n + 8), 3.0, 0.25)
        assert got.shape == (n + 8,)
        for part in (got[:64], got[n - 8:]):
            assert bool((part == 4.75).all())
        del got
        return
    big = torch.empty(n + 64, dtype=torch.float32, device=cuda)
    if case == "fma_offsets":
        a = big.as_strided((2, 16), (n, 1))
        a.copy_(torch.as_tensor(rng.normal(0, 10, (2, 16)),
                                dtype=torch.float32))
        c = torch.as_tensor(rng.normal(0, 10, (16,)), dtype=torch.float32,
                            device=cuda)
        _same_bits(xo._fma(a, 257.0, c),
                   xo.fma_reference(a.cpu(), 257.0, c.cpu()))
    else:
        a = big.as_strided((2, 16, 3), (n, 3, 1))
        a.copy_(torch.as_tensor(rng.normal(0, 10, (2, 16, 3)),
                                dtype=torch.float32))
        w = torch.as_tensor(rng.normal(0, 1, (2, 16, 1)), dtype=torch.float32,
                            device=cuda)
        _same_bits(xo._dot(w, a, 1), xo._dot(w.cpu(), a.cpu(), 1))
        _same_bits(xo._sum(a, 1), xo._sum(a.cpu(), 1))
    del big


def _fit_blocks(n, seed):
    """(n, 16, 4) RGBA blocks, whole numbers: `_blocks` with alpha, every
    fifth block solid (a singular least-squares system)."""
    px = torch.cat([_blocks(n, seed), _blocks(n, seed + 9)[..., :1]], -1)
    px[::5] = px[::5, :1]
    return px


@pytest.mark.cuda
@pytest.mark.parametrize("ls_iters", [1, 2])
@pytest.mark.parametrize("wb", [1, 2, 3, 4, 5])
@pytest.mark.parametrize("n_sub", [1, 2, 3])
@pytest.mark.parametrize("n_ch", [1, 2, 3, 4])
def test_line_fit_on_card(cuda, n_ch, n_sub, wb, ls_iters):
    """One `uastc_line_fit` launch gives the endpoints of its plain version
    run on the card (the generic kernels' chains) and on the CPU, bit for
    bit: every subset, empty subsets (every third block's past 0), solid
    blocks, pixels through a strided view, a ragged last CTA (2,999
    blocks) and one block."""
    from basis_universal_tpu_torch.codecs.uastc import encode as uenc

    n = 2999
    rng = np.random.default_rng(100 * n_ch + 10 * n_sub + wb)
    px = _fit_blocks(n, n_ch + wb)
    label = torch.as_tensor(rng.integers(0, n_sub, (n, 16)))
    label[::3] = 0
    levels = torch.as_tensor(uenc._weight_levels(wb))
    for b in (n, 1):
        v = px[:b, :, 4 - n_ch:]
        lab = label[:b] if n_sub > 1 or ls_iters == 2 else None
        card = (v.to(cuda), None if lab is None else lab.to(cuda), n_sub,
                levels.to(cuda), ls_iters)
        ck.reset_launch_counts()
        got = uenc.line_fit(*card)
        assert ck.LAUNCHES["uastc_line_fit"] == 1
        assert ck.LAUNCHES["xla_reduce"] == ck.LAUNCHES["xla_fma"] == 0
        for g, w in zip(got, uenc.line_fit_reference(*card)):
            assert torch.equal(g, w)
        for g, w in zip(got, uenc.line_fit_reference(v, lab, n_sub, levels,
                                                     ls_iters)):
            assert torch.equal(g.cpu(), w)


# (comps, weight bits, endpoint range, block counts): each instance at
# weight bits 1..5 on a strided view (2,999 blocks and one), then every
# single-subset mode of the search (RGB 0, 1, 5, 18, RGBA 10, 12, 14, LA
# 15) at the path's 24,576 contiguous blocks and 1,001 rows of 65 floats
MODE_TRIALS = [pytest.param(comps, wb, {1: 20, 2: 20, 3: 19, 4: 13, 5: 11}[wb],
                            (2999, 1), id=f"C{comps}-wb{wb}")
               for comps in (2, 3, 4) for wb in (1, 2, 3, 4, 5)]
MODE_TRIALS += [pytest.param(comps, wb, ep_range, (24576, 1001),
                             id=f"mode{mode}")
                for mode, wb, ep_range, comps in (
                    (0, 4, 19, 3), (1, 2, 20, 3), (5, 3, 20, 3),
                    (18, 5, 11, 3), (10, 4, 13, 4), (12, 3, 19, 4),
                    (14, 2, 20, 4), (15, 4, 20, 2))]


@pytest.mark.cuda
@pytest.mark.parametrize("ls_iters", [1, 2])
@pytest.mark.parametrize("comps,wb,ep_range,counts", MODE_TRIALS)
def test_mode_trial_on_card(cuda, comps, wb, ep_range, counts, ls_iters):
    """One `uastc_mode_trial` launch gives the errors, endpoint codes and
    weights of its plain version on the card and on the CPU, bit for bit:
    solid blocks, a ragged last warp and CTA, one block; pixels through a
    strided view (element loads), contiguous (16-byte loads) and in rows
    of 65 floats (element loads where a block is not 16-byte aligned)."""
    from basis_universal_tpu_torch.codecs.uastc import encode as uenc

    n = max(counts)
    blocks = _fit_blocks(n, comps + 10 * wb)
    # each view taken of its base tensor on the host and on the card
    if counts[0] == 2999:
        wide = blocks.repeat(1, 1, 2)
        views = [(lambda t, b=b: t[:b, :, ::2], wide) for b in counts]
    else:
        b = counts[1]
        rows = torch.cat([blocks[:b].reshape(b, 64), torch.zeros(b, 1)], 1)
        views = [(lambda t: t, blocks),
                 (lambda t: t.as_strided((b, 16, 4), (65, 4, 1)), rows)]
    args = (wb, ep_range, comps, ls_iters)
    for view, base in views:
        px, card = view(base), view(base.to(cuda))
        assert card.stride() == px.stride()
        ck.reset_launch_counts()
        got = uenc._mode_trial(card, *args)
        assert ck.LAUNCHES["uastc_mode_trial"] == 1
        assert sum(ck.LAUNCHES.values()) == 1
        for g, w in zip(got, uenc.mode_trial_reference(card, *args)):
            assert torch.equal(g, w)
        for g, w in zip(got, uenc.mode_trial_reference(px, *args)):
            assert torch.equal(g.cpu(), w)


# (weight bits, endpoint range, comps, subsets, pattern list, top-k): the
# modes of the searches (2, 4, 9, 16; 7 and 2 at effort 3's top-k 8; 3)
# and each instance at weight bits 1 and 5
SUBSET_TRIALS = [(3, 8, 3, 2, 2, 4), (2, 12, 3, 2, 2, 4), (2, 8, 4, 2, 2, 4),
                 (2, 20, 2, 2, 2, 4), (2, 12, 3, 2, 7, 8), (3, 8, 3, 2, 2, 8),
                 (2, 7, 3, 3, 3, 2), (1, 20, 3, 2, 2, 4), (5, 11, 4, 2, 2, 8),
                 (1, 20, 2, 2, 2, 8), (5, 11, 2, 2, 7, 4), (2, 7, 3, 3, 3, 8)]


@pytest.mark.cuda
@pytest.mark.parametrize("ls_iters", [1, 2])
@pytest.mark.parametrize("case", SUBSET_TRIALS)
def test_subset_trial_on_card(cuda, case, ls_iters):
    """One `uastc_subset_trial` launch gives the errors, endpoint codes,
    weights and patterns of its plain version on the card and on the CPU,
    bit for bit: solid blocks, pixels through a strided view, a ragged last
    CTA and one block."""
    from basis_universal_tpu_torch.codecs.uastc import encode as uenc

    wb, ep_range, comps, n_sub, plist, topk = case
    wide = _fit_blocks(2999, comps + 10 * wb + topk).repeat(1, 1, 2)
    args = (wb, ep_range, comps, ls_iters, n_sub, plist, topk)
    for b in (2999, 1):
        px = wide[:b, :, ::2]                       # a strided view
        ck.reset_launch_counts()
        got = uenc.subset_trial(px.to(cuda), *args)
        assert ck.LAUNCHES["uastc_subset_trial"] == 1
        assert sum(ck.LAUNCHES.values()) == 1
        for g, w in zip(got, uenc.subset_trial_reference(px.to(cuda), *args)):
            assert torch.equal(g, w)
        for g, w in zip(got, uenc.subset_trial_reference(px, *args)):
            assert torch.equal(g.cpu(), w)


@pytest.mark.cuda
@pytest.mark.parametrize("ls_iters", [1, 2])
@pytest.mark.parametrize("wb,ep_range,n_ch", [
    (2, 18, 3), (2, 13, 4), (1, 20, 4), (2, 20, 2), (5, 11, 3), (3, 19, 4),
    (4, 13, 2)])
def test_dualplane_trial_on_card(cuda, wb, ep_range, n_ch, ls_iters):
    """One `uastc_dualplane_trial` launch gives the errors, endpoint codes,
    interleaved weights and ccs (LA: none) of its plain version on the card
    and on the CPU, bit for bit."""
    from basis_universal_tpu_torch.codecs.uastc import encode as uenc

    wide = _fit_blocks(2999, n_ch + 10 * wb).repeat(1, 1, 2)
    args = (wb, ep_range, ls_iters, n_ch)
    for b in (2999, 1):
        px = wide[:b, :, ::2]
        ck.reset_launch_counts()
        got = uenc.dualplane_trial(px.to(cuda), *args)
        assert ck.LAUNCHES["uastc_dualplane_trial"] == 1
        assert sum(ck.LAUNCHES.values()) == 1
        assert len(got) == (3 if n_ch == 2 else 4)
        for g, w in zip(got, uenc.dualplane_trial_reference(px.to(cuda),
                                                            *args)):
            assert torch.equal(g, w)
        for g, w in zip(got, uenc.dualplane_trial_reference(px, *args)):
            assert torch.equal(g.cpu(), w)


# the trials of the searches at the paths' sizes (`chip_smoke.py` phase 3),
# in the wrappers' argument order: (weight bits, endpoint range, comps,
# steps, subsets, pattern list, top-k) of modes 2, 4, 9, 16, 7 (effort 3)
# and 3 (effort 3); (weight bits, endpoint range, steps, channels) of
# modes 6, 11, 13 and 17
PATH_SUBSET_TRIALS = [(3, 8, 3, 1, 2, 2, 4), (2, 12, 3, 1, 2, 2, 4),
                      (2, 8, 4, 1, 2, 2, 4), (2, 20, 2, 1, 2, 2, 4),
                      (2, 12, 3, 2, 2, 7, 8), (2, 7, 3, 2, 3, 3, 2)]
PATH_DUALPLANE_TRIALS = [(2, 18, 1, 3), (2, 13, 1, 4), (1, 20, 1, 4),
                         (2, 20, 1, 2)]


@pytest.mark.cuda
@pytest.mark.parametrize("n", [24576, 1001])
@pytest.mark.parametrize("args", PATH_SUBSET_TRIALS + PATH_DUALPLANE_TRIALS)
def test_trials_on_card_at_the_paths_sizes(cuda, args, n):
    """`uastc_subset_trial` / `uastc_dualplane_trial` at each mode of the
    searches, on 24,576 blocks (a 768x512 image: the most blocks a warp
    takes) and 1,001 (a block a warp, a ragged last CTA): every output its
    plain version's on the card, `torch.equal`."""
    from basis_universal_tpu_torch.codecs.uastc import encode as uenc

    px = _fit_blocks(n, 7 * len(args) + args[0] + n).to(cuda)
    run, plain = ((uenc.subset_trial, uenc.subset_trial_reference)
                  if len(args) == 7 else
                  (uenc.dualplane_trial, uenc.dualplane_trial_reference))
    got = run(px, *args)
    want = plain(px, *args)
    assert len(got) == len(want)
    for g, w in zip(got, want):
        assert torch.equal(g, w)


@pytest.mark.cuda
@pytest.mark.parametrize("alpha", [False, True])
def test_uastc_search_launches_on_card(cuda, alpha):
    """The effort-2 search launches, per image, one `uastc_mode_trial` per
    single-subset mode (RGB 4, RGBA 8), one `uastc_subset_trial` per
    2-subset mode (2, 3) and one `uastc_dualplane_trial` per dual-plane
    mode (1, 4), and no line fit or generic XLA-order kernel outside them;
    its blocks are the CPU's."""
    from basis_universal_tpu_torch.codecs.uastc import encode, pack
    from basis_universal_tpu_torch.ops.etc1 import image_to_blocks
    from basis_universal_tpu_torch.testing.synthetic import synthetic_texture

    img = synthetic_texture(64, 64, seed=5, alpha=alpha)[0]
    if not alpha:
        img = np.concatenate([img, np.full((64, 64, 1), 255, np.uint8)], -1)
    px = torch.as_tensor(image_to_blocks(img).reshape(-1, 16, 4),
                         dtype=torch.float32)
    modes, ls_iters, extra, topk = pack._effort_mode_set(2, alpha)
    ck.reset_launch_counts()
    got = encode._search(px.to(cuda), modes, ls_iters, extra, topk)
    want = dict(xla_reduce=0, xla_fma=0, uastc_mode_trial=8,
                uastc_subset_trial=3, uastc_dualplane_trial=4,
                uastc_line_fit=0) if alpha else dict(
        xla_reduce=0, xla_fma=0, uastc_mode_trial=4, uastc_subset_trial=2,
        uastc_dualplane_trial=1, uastc_line_fit=0)
    assert {k: ck.LAUNCHES[k] for k in want} == want
    np.testing.assert_array_equal(
        got, encode._search(px, modes, ls_iters, extra, topk))


@pytest.mark.cuda
@pytest.mark.parametrize("n", [1, 255, 1001, 4096, 24575, 24576])
@pytest.mark.parametrize("effort,alpha", [(e, a) for e in (1, 2, 3, 4)
                                          for a in (False, True)])
def test_uastc_pack_on_card(cuda, effort, alpha, n):
    """The kernel gives `pack_reference`'s bytes on every slot (and on rows
    of no slot), from a buffer 16-byte aligned and from one 5 bytes past;
    one launch per call."""
    from basis_universal_tpu_torch.codecs.uastc import pack
    from basis_universal_tpu_torch.testing.synthetic import \
        uastc_winner_buffer

    rng = np.random.default_rng(1000 * effort + 10 * alpha + n % 7)
    modes, _, extra, _ = pack._effort_mode_set(effort, alpha)
    compact = torch.as_tensor(uastc_winner_buffer(modes, extra, n,
                                                  seed=int(rng.integers(99))))
    alpha0 = torch.as_tensor(rng.integers(0, 1024, n), dtype=torch.int32)
    want = pack.pack_reference(compact, alpha0, pack.pack_tables(modes, extra))
    tabs = pack.pack_tables(modes, extra, cuda)
    buf = torch.zeros(compact.numel() + 16, dtype=torch.uint8, device=cuda)
    for offset in (0, 5):
        c = buf[offset:offset + compact.numel()].view(n, 59)
        c.copy_(compact)
        got = pack.uastc_pack(c, alpha0.to(cuda), tabs)
        torch.cuda.synchronize()
        assert torch.equal(got.cpu(), want)
    assert ck.LAUNCHES["uastc_pack"] == 2


@pytest.mark.cuda
@pytest.mark.parametrize("radius", [0, 1, 2])
def test_perceptual_scan_and_rescore_on_card_are_the_plain_versions(
        cuda, radius):
    """With the perceptual metric the scan (its shortlist, and the cluster
    scan's gray-axis sums at given cluster levels) and the rescore (a
    palette flagged as the transform's trailing rows included) give their
    plain versions' bits on the card; at 525 blocks the candidate-base
    array has trailing rows."""
    from basis_universal_tpu_torch.ops import etc1s_encode as ops

    px = _blocks(525, 40 + radius)
    got = ck.factorized_scan_shortlist(px.to(cuda), radius=radius,
                                       perceptual=True)
    want = ck.factorized_scan_shortlist_reference(px, radius=radius,
                                                  perceptual=True)
    assert torch.equal(got.cpu(), want)
    rng = np.random.default_rng(radius)
    n_d = (2 * radius + 1) ** 3
    base5 = torch.as_tensor(rng.integers(0, 32, (525, 3)),
                            dtype=torch.float32)
    lb = torch.as_tensor(rng.uniform(0, 500, (525, n_d)), dtype=torch.float32)
    got = ck.factorized_scan(px.to(cuda), base5=base5.to(cuda), radius=radius,
                             perceptual=True, lb=lb.to(cuda))
    want = ck.factorized_scan_reference(px, base5, radius, True, lb)
    assert torch.equal(got.cpu(), want)
    c5 = rng.integers(0, 32, (525, 16, 3))
    packed = torch.as_tensor(c5[..., 0] | (c5[..., 1] << 5)
                             | (c5[..., 2] << 10)
                             | (rng.integers(0, 8, (525, 16)) << 15),
                             dtype=torch.int32)
    packed[::7, 3] |= ops.PERC_TAIL_BIT
    got = ck.palette_errs_packed(px.to(cuda), packed.to(cuda),
                                 perceptual=True)
    assert torch.equal(got.cpu(), ck.palette_errs_packed_reference(
        px, packed, perceptual=True))


@pytest.mark.cuda
@pytest.mark.parametrize("size,quality,effort", [
    ((84, 100), 128, 1), ((128, 128), 80, 2)])
def test_perceptual_compress_on_card_gives_the_cpus_bytes(cuda, size,
                                                          quality, effort):
    """ETC1S with the perceptual metric: the card's file is the CPU's (which
    the CPU tests hold to the reference's bytes), at settings whose
    transforms have trailing rows (525 blocks; odd codebooks)."""
    from basis_universal_tpu_torch import compressor
    from basis_universal_tpu_torch.testing.synthetic import synthetic_texture

    img, _ = synthetic_texture(*size, seed=8)
    kw = dict(quality_level=quality, effort=effort, perceptual_metric=True)
    card = compressor.compress(img, compressor.CompressorParams(
        device="cuda", **kw))
    cpu = compressor.compress(img, compressor.CompressorParams(
        device="cpu", **kw))
    assert card.basis_data == cpu.basis_data


def _htod_copies(trace_json):
    """[(bytes, innermost frame of the port that made it)] of every
    host-to-device copy in a Chrome trace recorded with_stack."""
    import json

    events = json.loads(trace_json.read_text())["traceEvents"]
    runtime = {e["args"]["correlation"]: e for e in events
               if e.get("cat") == "cuda_runtime" and "correlation"
               in e.get("args", {})}
    frames = [e for e in events if e.get("cat") == "python_function"
              and "basis_universal_tpu_torch/" in e.get("name", "")]
    out = []
    for e in events:
        if e.get("cat") != "gpu_memcpy" or "HtoD" not in e.get("name", ""):
            continue
        call = runtime.get(e["args"].get("correlation"))
        site = [f for f in frames if call is not None
                and f["ts"] <= call["ts"] <= f["ts"] + f.get("dur", 0)]
        name = max(site, key=lambda f: f["ts"])["name"] if site else "?"
        out.append((int(e["args"]["bytes"]), name.split(
            "basis_universal_tpu_torch/")[-1]))
    return out


@pytest.mark.cuda
@pytest.mark.parametrize("codec", ["ETC1S", "UASTC_LDR_4x4"])
def test_upload_counter_is_the_htod_copies_on_card(cuda, codec, tmp_path):
    """One 768x512 texture through compress_batch under the profiler (CPU and
    CUDA, with Python stacks), the recorder on: every upload the
    `upload_bytes` counter counts is one `Memcpy HtoD` of its bytes; the
    copies it leaves out are small, and printed with the frame that made
    them."""
    from torch.profiler import ProfilerActivity, profile

    from basis_universal_tpu_torch import compressor
    from basis_universal_tpu_torch.formats.constants import BasisTexFormat
    from basis_universal_tpu_torch.testing.synthetic import synthetic_texture
    from basis_universal_tpu_torch.utils import telemetry

    img = synthetic_texture(512, 768, seed=3)[0]
    blocks = 512 * 768 // 16
    params = compressor.CompressorParams(
        tex_format=BasisTexFormat[codec], effort=2 if codec != "ETC1S" else 1,
        device="cuda")
    compressor.compress_batch([img], params)        # builds and caches
    torch.cuda.synchronize()
    telemetry.drain()
    telemetry.record(True)
    try:
        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA],
                     with_stack=True) as prof:
            compressor.compress_batch([img], params)
            torch.cuda.synchronize()
    finally:
        telemetry.record(False)
    _, counters = telemetry.drain()
    prof.export_chrome_trace(str(tmp_path / "trace.json"))
    copies = _htod_copies(tmp_path / "trace.json")
    if codec == "ETC1S":
        from basis_universal_tpu_torch.codecs.etc1s import frontend

        # the pixels, the fill indices of empty k-means seeds, the neighbours
        knobs, _, _ = frontend._knobs_and_neighbors(
            blocks, compressor._frontend_params(params, blocks), None)
        counted = [48 * blocks, 8 * knobs["num_e"], 4 * blocks, 4 * blocks]
    else:
        counted = [64 * blocks]
    assert counters["upload_bytes"] == (len(counted), sum(counted))
    left = list(copies)
    for n in counted:
        match = [c for c in left if c[0] == n]
        assert match, (n, copies)
        left.remove(match[0])
    by_site = {}
    for n, site in left:
        entry = by_site.setdefault(site, [0, 0])
        entry[0] += 1
        entry[1] += n
    print(f"\n{codec}: {len(copies)} HtoD copies, {sum(c[0] for c in copies)}"
          f" B; counted {len(counted)}, {sum(counted)} B; left out "
          f"{len(left)}, {sum(n for n, _ in left)} B:")
    for site, (k, n) in sorted(by_site.items(), key=lambda kv: -kv[1][0]):
        print(f"  {k} x, {n} B: {site}")
    assert sum(n for n, _ in left) < 0.05 * sum(counted)


def _etc1s_batch(size, seeds, **kw):
    """(blocks, frontend params, neighbours) of synthetic ETC1S textures
    of one size, as `compressor.compress_batch` makes them."""
    from basis_universal_tpu_torch import compressor
    from basis_universal_tpu_torch.testing.synthetic import synthetic_texture

    params = compressor.CompressorParams(device="cuda", **kw)
    per = [compressor._prepare_slices([synthetic_texture(*size, seed=s)[0]],
                                      params) for s in seeds]
    blocks = [np.concatenate([s["blocks"] for s in sl]) for sl in per]
    fp = compressor._frontend_params(params, len(blocks[0]))
    return blocks, fp, [compressor._slice_neighbors(sl) for sl in per]


def _same_frontend_outputs(got, want):
    import dataclasses

    from basis_universal_tpu_torch.codecs.etc1s import frontend

    assert len(got) == len(want)
    for g, w in zip(got, want):
        for f in dataclasses.fields(frontend.FrontendOutput):
            np.testing.assert_array_equal(getattr(g, f.name),
                                          getattr(w, f.name), f.name)


@pytest.mark.cuda
@pytest.mark.parametrize("perceptual", [False, True])
def test_frontend_impl_never_syncs_on_card(cuda, perceptual):
    """`_frontend_impl` at Kodak size reads nothing back from the card and
    copies nothing from the host once its constant tables are made: it
    runs under `set_sync_debug_mode("error")`, to the first call's bits."""
    from basis_universal_tpu_torch.codecs.etc1s import frontend
    from basis_universal_tpu_torch.ops import etc1s_encode as ops

    (blocks,), fp, (nbr,) = _etc1s_batch((512, 768), [0],
                                         perceptual_metric=perceptual)
    knobs, left, up = frontend._knobs_and_neighbors(len(blocks), fp, nbr)
    (fill,) = frontend.fill_indices([0], len(blocks), knobs["num_e"])
    args = [frontend.upload(a, cuda) for a in (blocks, fill, left, up)]
    args += [float(fp.endpoint_rdo_thresh), float(fp.selector_rdo_thresh)]
    with ops.exact_matmuls():
        want = frontend._frontend_impl(*args, **knobs)
        torch.cuda.synchronize()
        torch.cuda.set_sync_debug_mode("error")
        try:
            got = frontend._frontend_impl(*args, **knobs)
        finally:
            torch.cuda.set_sync_debug_mode("default")
    for g, w in zip(got, want):
        assert torch.equal(g, w)


@pytest.mark.cuda
@pytest.mark.parametrize("size", [(512, 768), (2048, 2048)])
def test_frontend_graph_replays_give_the_eager_bits_on_card(cuda, size):
    """Three textures a batch at B 24,576 and at 2K: the eager runs' five
    outputs, texture for texture, from the batch's warm-up, its capture and
    its replays; a quality-64 key captured after the quality-128 one, and
    the quality-128 graph replayed again after it. The device trace sees
    each texture's kernels, replayed or not; the wrappers count only the
    warm-up's, not the capture's nor a replay's."""
    from basis_universal_tpu_torch.codecs.etc1s import frontend
    from basis_universal_tpu_torch.testing.launches import traced_launches
    from basis_universal_tpu_torch.utils import telemetry

    frontend.drop_graphs()
    runs = {}
    for quality in (128, 64):
        blocks, fp, nbrs = _etc1s_batch(size, (3, 4, 5),
                                        quality_level=quality)
        knobs, _, _ = frontend._knobs_and_neighbors(len(blocks[0]), fp,
                                                    nbrs[0])
        fills = frontend.fill_indices([100, 101, 102], len(blocks[0]),
                                      knobs["num_e"])
        ck.reset_launch_counts()
        eager, traced = traced_launches(lambda: [
            frontend._run_one(b, fp, knobs, *n, fill, cuda)
            for b, n, fill in zip(blocks, nbrs, fills)])
        assert traced == ck.LAUNCHES
        launches = {k: v // 3 for k, v in ck.LAUNCHES.items()}
        ck.reset_launch_counts()
        telemetry.drain()
        telemetry.record(True)
        try:
            batch, traced = traced_launches(lambda: list(
                frontend.compress_batch_iter(blocks, fp, seed=100,
                                             neighbors=nbrs)))
        finally:
            telemetry.record(False)
        counters = telemetry.drain()[1]
        assert counters["etc1s.frontend.graph_captures"][0] == 1
        assert counters["etc1s.frontend.graph_replays"][0] == 2
        assert traced == {k: 3 * v for k, v in launches.items()}
        assert ck.LAUNCHES == launches
        _same_frontend_outputs(batch, eager)
        ck.reset_launch_counts()
        again, traced = traced_launches(lambda: frontend._run_one(
            blocks[0], fp, knobs, *nbrs[0], fills[0], cuda))
        assert traced == launches
        assert not any(ck.LAUNCHES.values())
        _same_frontend_outputs([again], eager[:1])
        runs[quality] = blocks, fp, nbrs, eager
    assert len(frontend._GRAPHS) == 2
    blocks, fp, nbrs, eager = runs[128]
    _same_frontend_outputs(list(frontend.compress_batch_iter(
        blocks, fp, seed=100, neighbors=nbrs)), eager)
    assert len(frontend._GRAPHS) == 2
    frontend.drop_graphs()


@pytest.mark.cuda
def test_compress_batch_files_are_eager_compress_files_on_card(cuda):
    """`compress_batch`'s files, whose frontends replay a captured graph
    from the second texture on, are those of each texture's own eager
    `compress` byte for byte."""
    import dataclasses

    from basis_universal_tpu_torch import compressor
    from basis_universal_tpu_torch.codecs.etc1s import frontend
    from basis_universal_tpu_torch.testing.synthetic import synthetic_texture

    imgs = [synthetic_texture(128, 192, seed=40 + i)[0] for i in range(4)]
    params = compressor.CompressorParams(device="cuda")
    frontend.drop_graphs()
    single = [compressor.compress(img, dataclasses.replace(
        params, seed=params.seed + i)) for i, img in enumerate(imgs)]
    assert not frontend._GRAPHS
    batch = compressor.compress_batch(imgs, params)
    assert len(frontend._GRAPHS) == 1
    assert [o.basis_data for o in batch] == [o.basis_data for o in single]
    assert [o.ktx2_data for o in batch] == [o.ktx2_data for o in single]
    frontend.drop_graphs()


@pytest.mark.cuda
def test_mesh_with_the_card_named_twice_replays_graphs_on_card(cuda):
    """`compress_batch_sharded` over the card named twice, four textures a
    device thread: the files of `compress_batch`; the device trace sees
    each texture's kernels once (a lone eager `compress`'s counts), while
    the wrappers count only the textures that ran eagerly, those the
    recorder does not count as replays."""
    from basis_universal_tpu_torch import compressor
    from basis_universal_tpu_torch.codecs.etc1s import frontend
    from basis_universal_tpu_torch.parallel import mesh
    from basis_universal_tpu_torch.testing.launches import traced_launches
    from basis_universal_tpu_torch.testing.synthetic import synthetic_texture
    from basis_universal_tpu_torch.utils import telemetry

    imgs = [synthetic_texture(128, 192, seed=60 + i)[0] for i in range(8)]
    params = compressor.CompressorParams(device="cuda")
    frontend.drop_graphs()
    ck.reset_launch_counts()
    compressor.compress(imgs[0], params)
    torch.cuda.synchronize()
    per_image = dict(ck.LAUNCHES)
    assert per_image["bisect_rows"] == 1 and not frontend._GRAPHS
    ck.reset_launch_counts()
    telemetry.drain()
    telemetry.record(True)
    try:
        got, traced = traced_launches(lambda: mesh.compress_batch_sharded(
            imgs, params, ["cuda:0", "cuda:0"]))
    finally:
        telemetry.record(False)
    counters = telemetry.drain()[1]
    replays = counters["etc1s.frontend.graph_replays"][0]
    assert counters["etc1s.frontend.graph_captures"][0] == 1
    assert 6 <= replays <= 7
    assert traced == {k: 8 * v for k, v in per_image.items()}
    assert ck.LAUNCHES == {k: (8 - replays) * v for k, v in per_image.items()}
    want = compressor.compress_batch(imgs, params)
    assert [o.basis_data for o in got] == [o.basis_data for o in want]
    frontend.drop_graphs()
