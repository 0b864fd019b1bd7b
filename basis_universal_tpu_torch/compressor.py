"""basis_compressor equivalent: image(s) -> .basis/.KTX2 bytes, for every
texture format the reference package encodes.

Counterpart of `basis_universal_tpu/compressor.py`: read sources -> mipmaps
-> extract blocks -> device search (PyTorch on `params.device`: the ETC1S
frontend, the UASTC mode search, which ASTC LDR 4x4 and XUASTC LDR 4x4
share, or the BC7 search of XUBC7) -> host stages (ETC1S entropy coding,
native when available; UASTC/ASTC block packing and RDO; the XUASTC and
XUBC7 entropy layers; the larger ASTC footprints and the HDR modes are host
code throughout) -> container writers. The host stages are this package's
copies of the reference's jax-free modules; the functions below are copies
of the reference's (that module imports the JAX frontend at the top), with
`params.device` handed to each device search.
"""

import concurrent.futures as cf
import dataclasses
from typing import List, Optional, Sequence

import numpy as np

from . import native as native_mod
from .codecs.etc1s import backend as etc1s_backend
from .codecs.etc1s import frontend as etc1s_frontend
from .codecs.uastc import encode as uastc_encode
from .codecs.uastc import pack as uastc_pack
from .formats import basis_file, ktx2
from .formats.constants import (
    BasisTexFormat,
    BasisTextureType,
    HeaderFlags,
    SliceDescFlags,
)
from .ops.etc1 import image_to_blocks, pack_etc1_blocks
from .utils import telemetry
from .utils.crc import crc16

MAX_ENDPOINT_CLUSTERS = 16128
MAX_SELECTOR_CLUSTERS = 16128


def etc1s_quality_to_clusters(quality_level: int, total_blocks: int):
    """quality 1-255 -> (max_endpoint_clusters, max_selector_clusters),
    the reference encoder's curves (basisu_comp.cpp:3325-3382)."""
    q = min(max(quality_level, 1), 255) / 255.0
    total_texels = total_blocks * 16.0

    bits_per_endpoint_cluster = 14.0
    max_endpoints = int(total_texels / bits_per_endpoint_cluster)
    mid = 128.0 / 255.0
    MID_SIZE = 4800
    MAX_SIZE = 8192
    if q <= mid:
        ceq = 0.5 * (q / mid) ** 0.65
        max_endpoints = min(max(min(max(max_endpoints, 256), MID_SIZE), 64),
                            total_blocks)
        endpoint_clusters = int(0.5 + 32 + (max_endpoints - 32) * ceq)
    else:
        ceq = ((q - mid) / (1.0 - mid)) ** 1.6
        max_endpoints = min(max(max_endpoints, 256), MAX_SIZE)
        max_endpoints = min(max_endpoints, total_blocks)
        max_endpoints = max(max_endpoints, MID_SIZE)
        endpoint_clusters = int(0.5 + MID_SIZE
                                + (max_endpoints - MID_SIZE) * ceq)
    endpoint_clusters = min(max(endpoint_clusters, 32), MAX_ENDPOINT_CLUSTERS)

    max_selectors = int(total_texels / 14.0)
    max_selectors = min(max(max_selectors, 256), MAX_SELECTOR_CLUSTERS)
    max_selectors = min(max_selectors, total_blocks)
    max_selectors = max(max_selectors, 96)
    csq = q ** 2.62
    selector_clusters = int(0.5 + 96 + (max_selectors - 96) * csq)
    selector_clusters = min(max(selector_clusters, 8), MAX_SELECTOR_CLUSTERS)
    return endpoint_clusters, selector_clusters


@dataclasses.dataclass
class CompressorParams:
    tex_format: BasisTexFormat = BasisTexFormat.ETC1S
    quality_level: int = 128       # ETC1S: 1-255 (reference -q)
    effort: int = 1                # 0-10 (reference etc1s comp_level 0-6)
    perceptual: bool = True
    # luma-weighted metric in the frontend scans and the backend RDO
    perceptual_metric: bool = False
    mip_gen: bool = False
    mip_smallest_dimension: int = 1
    mip_filter: str = "kaiser"
    mip_srgb: bool = True
    mip_premultiplied: bool = False
    mip_renormalize: bool = False
    mip_wrapping: bool = False
    tex_type: BasisTextureType = BasisTextureType.TEX_2D
    us_per_frame: int = 66666
    userdata0: int = 0
    userdata1: int = 0
    max_endpoint_clusters: Optional[int] = None   # override quality mapping
    max_selector_clusters: Optional[int] = None
    endpoint_rdo_thresh: float = 1.35
    selector_rdo_thresh: float = 1.15
    # shared/global codebooks: (color5 (E,3), inten5 (E,), selectors (S,16))
    global_codebooks: Optional[tuple] = None
    # UASTC RDO (selector-bit-range matching): 0 disables; 1.0 = default
    # strength
    rdo_uastc_quality: float = 0.0
    rdo_uastc_dict_size: int = 4096
    # XUBC7 "poor man's RDO" level 0-100: 0 = off; >0 enables the
    # repeat/solid/endpoint RDO pre-passes
    xubc7_rdo_level: int = 0
    # XUASTC entropy syntax: 'full_zstd' | 'hybrid' | 'arith' | 'auto'
    # ('auto' emits every syntax and keeps the smallest per slice)
    xuastc_syntax: str = "full_zstd"
    seed: int = 0
    # torch device of every device search
    device: str = "cuda"


@dataclasses.dataclass
class CompressorOutput:
    basis_data: bytes
    ktx2_data: bytes
    num_endpoints: int
    num_selectors: int
    slice_endpoints: List[np.ndarray]
    slice_selectors: List[np.ndarray]


def _prepare_slices(images: Sequence[np.ndarray], params: CompressorParams):
    """images -> per-slice dicts. Alpha sources produce two ETC1S slices per
    level: RGB and an (a,a,a) grayscale alpha slice."""
    from .ops.resample import generate_mipmaps

    slices = []
    for image_index, img in enumerate(images):
        img = np.asarray(img)
        if img.ndim == 2:
            img = img[..., None].repeat(3, axis=-1)
        has_alpha = img.shape[-1] == 4 and bool((img[..., 3] != 255).any())
        levels = [img]
        if params.mip_gen:
            levels += generate_mipmaps(
                img, params.mip_smallest_dimension,
                filter=params.mip_filter, srgb=params.mip_srgb,
                premultiplied=params.mip_premultiplied,
                renormalize=params.mip_renormalize,
                wrap=params.mip_wrapping)
        for level_index, lvl in enumerate(levels):
            h, w = lvl.shape[:2]
            rgb_blocks = np.ascontiguousarray(image_to_blocks(lvl[..., :3]))
            by, bx = rgb_blocks.shape[:2]
            slices.append(dict(
                image_index=image_index, level_index=level_index,
                orig_width=w, orig_height=h,
                num_blocks_x=bx, num_blocks_y=by, alpha=False,
                blocks=rgb_blocks.reshape(by * bx, 16, 3),
            ))
            if has_alpha:
                a = lvl[..., 3:4].repeat(3, axis=-1)
                a_blocks = np.ascontiguousarray(image_to_blocks(a))
                slices.append(dict(
                    image_index=image_index, level_index=level_index,
                    orig_width=w, orig_height=h,
                    num_blocks_x=bx, num_blocks_y=by, alpha=True,
                    blocks=a_blocks.reshape(by * bx, 16, 3),
                ))
    return slices


def _rdo_thresholds(params: CompressorParams):
    """Quality-scaled RDO thresholds (basisu_comp.cpp:3383-3422)."""
    e_t, s_t = params.endpoint_rdo_thresh, params.selector_rdo_thresh
    q = params.quality_level
    if q <= 100:
        e_t = max(e_t, 1.5)
        s_t = max(s_t, 1.25)
    if q >= 223:
        scale = 0.25
    elif q >= 192:
        scale = 0.5
    elif q >= 160:
        scale = 0.75
    elif q >= 129:
        l = (q / 255.0 - 129 / 255.0) / ((160 - 129) / 255.0)
        scale = 1.0 + (0.75 - 1.0) * l
    else:
        scale = 1.0
    if params.effort >= 3:
        scale *= 0.72
    elif params.effort == 2:
        scale *= 0.85
    return (max(1.0, 1.0 + (e_t - 1.0) * scale),
            max(1.0, 1.0 + (s_t - 1.0) * scale))


def _frontend_params(params: CompressorParams, total_blocks: int):
    if params.max_endpoint_clusters and params.max_selector_clusters:
        num_e, num_s = params.max_endpoint_clusters, params.max_selector_clusters
    else:
        num_e, num_s = etc1s_quality_to_clusters(params.quality_level,
                                                 total_blocks)
    # the stream-state RDO runs in the native backend (_assemble); the
    # device neighbour-copy RDO is only the fallback without the native lib
    e_t, s_t = _rdo_thresholds(params)
    dev_rdo = params.effort >= 1 and not native_mod.available()
    return etc1s_frontend.FrontendParams(
        max_endpoint_clusters=num_e,
        max_selector_clusters=num_s,
        effort=params.effort,
        perceptual=params.perceptual_metric,
        endpoint_rdo_thresh=e_t if dev_rdo else 1.0,
        selector_rdo_thresh=s_t if dev_rdo else 1.0,
        device=params.device,
    )


def _slice_neighbors(slices):
    """Flat left/up neighbour indices for concatenated per-slice grids."""
    left = []
    up = []
    ofs = 0
    for s in slices:
        by, bx = s["num_blocks_y"], s["num_blocks_x"]
        idx = np.arange(by * bx, dtype=np.int32).reshape(by, bx)
        l = np.full((by, bx), -1, dtype=np.int32)
        l[:, 1:] = idx[:, :-1] + ofs
        u = np.full((by, bx), -1, dtype=np.int32)
        u[1:, :] = idx[:-1, :] + ofs
        left.append(l.ravel())
        up.append(u.ravel())
        ofs += by * bx
    return np.concatenate(left), np.concatenate(up)


def _ktx2_layout(params: CompressorParams, slices):
    """KTX2 (level_count, layer_count, face_count) and per-slice
    level/layer/face from the flat image_index numbering."""
    level_count = max(s["level_index"] for s in slices) + 1
    layer_count = max(s["image_index"] for s in slices) + 1
    face_count = 1
    if params.tex_type == BasisTextureType.CUBEMAP_ARRAY:
        if layer_count % 6:
            raise ValueError("cubemaps need a multiple of 6 images")
        face_count = 6
        layer_count //= 6
    info = [dict(level=s["level_index"],
                 layer=s["image_index"] // face_count,
                 face=s["image_index"] % face_count)
            for s in slices]
    return level_count, layer_count, face_count, info


def compress(images, params: CompressorParams = CompressorParams()
             ) -> CompressorOutput:
    """Encode RGB(A) uint8 image(s), or float32 RGB for the HDR formats, to
    .basis/.KTX2 in `params.tex_format`."""
    if isinstance(images, np.ndarray):
        images = [images]
    if params.tex_format == BasisTexFormat.UASTC_LDR_4x4:
        return _compress_uastc(images, params)
    if params.tex_format == BasisTexFormat.UASTC_HDR_4x4:
        return _compress_uastc_hdr(images, params)
    from .transcoder import ASTC_LDR_BLOCK_SIZES, XUASTC_LDR_FORMATS
    if params.tex_format in ASTC_LDR_BLOCK_SIZES:
        return _compress_astc_ldr(images, params,
                                  *ASTC_LDR_BLOCK_SIZES[params.tex_format])
    if params.tex_format in XUASTC_LDR_FORMATS:
        bw, bh = map(int, params.tex_format.name.split("_")[-1].split("x"))
        return _compress_xuastc_ldr(images, params, bw, bh)
    if params.tex_format == BasisTexFormat.XUBC7:
        return _compress_xubc7(images, params)
    if params.tex_format == BasisTexFormat.ASTC_HDR_6x6:
        return _compress_astc_hdr_6x6(images, params)
    if params.tex_format == BasisTexFormat.UASTC_HDR_6x6_INTERMEDIATE:
        return _compress_uastc_hdr_6x6i(images, params)
    if params.tex_format != BasisTexFormat.ETC1S:
        raise ValueError(f"{params.tex_format!r} is not an encodable format")
    slices = _prepare_slices(images, params)
    total_blocks = sum(s["blocks"].shape[0] for s in slices)
    all_blocks = np.concatenate([s["blocks"] for s in slices], axis=0)
    if params.global_codebooks is not None:
        c5, i5, sel = params.global_codebooks
        fe = etc1s_frontend.compress_with_global_codebooks(
            all_blocks, c5, i5, sel, effort=params.effort,
            perceptual=params.perceptual_metric, device=params.device)
        return _assemble(slices, fe, params, use_global=True)
    fp = _frontend_params(params, total_blocks)
    fe = etc1s_frontend.compress(all_blocks, fp, seed=params.seed,
                                 neighbors=_slice_neighbors(slices))
    return _assemble(slices, fe, params)


def compress_batch(images, params: CompressorParams = CompressorParams()):
    """Encode N textures; returns one CompressorOutput per input. Same-sized
    inputs share the frontend's knobs and run one image at a time, image i
    with seed + i; the host assembly of image i overlaps the device work of
    the images after it. Mixed sizes fall back to per-image `compress`.
    UASTC groups same-shaped slices across images instead. ETC1S and
    UASTC LDR 4x4 only, as in the reference. Each call is a span of the
    recorder (`utils/telemetry.py`), and so is each stage of it.

    On a CUDA device the ETC1S frontend of the second same-shaped image on
    replays one captured CUDA graph. The graph and its private memory pool
    (some 2.75 GB at 2K) stay reserved after the call, up to four of them
    (the least recently used dropped), so that a later call of that shape
    replays at once; `codecs.etc1s.frontend.drop_graphs()` frees them."""
    with telemetry.span("compress_batch", new_call=True):
        if params.tex_format == BasisTexFormat.UASTC_LDR_4x4:
            return _compress_uastc_batch(images, params)
        if params.tex_format != BasisTexFormat.ETC1S:
            raise ValueError("compress_batch encodes ETC1S and UASTC LDR "
                             f"4x4; use compress for {params.tex_format!r}")
        return _compress_etc1s_batch(images, params)


def _compress_etc1s_batch(images, params: CompressorParams):
    with telemetry.span("etc1s.prep"):
        per_image = [_prepare_slices([img], params) for img in images]
        shapes = {tuple((s["num_blocks_x"] * s["num_blocks_y"], s["alpha"])
                        for s in sl) for sl in per_image}
        if len(shapes) == 1:
            total_blocks = sum(s["blocks"].shape[0] for s in per_image[0])
            fp = _frontend_params(params, total_blocks)
            batch = [np.concatenate([s["blocks"] for s in sl], axis=0)
                     for sl in per_image]
            nbrs = [_slice_neighbors(sl) for sl in per_image]
    if len(shapes) != 1:
        return [compress(img, params) for img in images]
    ex = cf.ThreadPoolExecutor(8)
    try:
        # each job's parent: the span that produced its frontend output
        futs = [ex.submit(_assemble_job, sl, fe, params, telemetry.last())
                for sl, fe in zip(per_image,
                                  etc1s_frontend.compress_batch_iter(
                                      batch, fp, seed=params.seed,
                                      neighbors=nbrs))]
    finally:
        with telemetry.span("etc1s.drain"):
            ex.shutdown()
    return [f.result() for f in futs]


def _assemble_job(slices, fe, params: CompressorParams, parent):
    """One texture's `_assemble` on the pool, a span whose parent is the
    frontend span (on the main thread) that produced fe."""
    with telemetry.span("etc1s.assembly", parent=parent):
        return _assemble(slices, fe, params)


def _prep_uastc_slices(images, params: CompressorParams):
    """Per-slice pixel prep for UASTC (no encoding): returns (slices,
    any_alpha) where each slice dict carries its (B,16,4) f32 `px`."""
    from .ops.resample import generate_mipmaps

    slices = []
    any_alpha = False
    for image_index, img in enumerate(images):
        img = np.asarray(img)
        if img.ndim == 2:
            img = img[..., None].repeat(3, axis=-1)
        if img.shape[-1] == 3:
            img = np.concatenate(
                [img, np.full(img.shape[:2] + (1,), 255, np.uint8)], axis=-1)
        has_alpha = bool((img[..., 3] != 255).any())
        any_alpha |= has_alpha
        levels = [img]
        if params.mip_gen:
            levels += generate_mipmaps(
                img, params.mip_smallest_dimension,
                filter=params.mip_filter, srgb=params.mip_srgb,
                premultiplied=params.mip_premultiplied,
                renormalize=params.mip_renormalize,
                wrap=params.mip_wrapping)
        for level_index, lvl in enumerate(levels):
            h, w = lvl.shape[:2]
            blocks = image_to_blocks(lvl).astype(np.float32)
            by, bx = blocks.shape[:2]
            slices.append(dict(
                image_index=image_index, level_index=level_index,
                orig_width=w, orig_height=h, num_blocks_x=bx,
                num_blocks_y=by, alpha=has_alpha,
                px=blocks.reshape(by * bx, 16, 4)))
    return slices, any_alpha


def _encode_uastc_slices(slice_groups, params: CompressorParams):
    """Encode UASTC slice dicts in place (sets `data`); same-shaped slices,
    across images, go through one `encode_blocks_batch`."""
    groups = {}
    for s in slice_groups:
        groups.setdefault((s["px"].shape, s["alpha"]), []).append(s)
    for (_shape, alpha), members in groups.items():
        px_list = [s["px"] for s in members]
        for s, ub in zip(members, uastc_encode.encode_blocks_batch(
                px_list, effort=params.effort, has_alpha=alpha,
                device=params.device,
                textures=[s.get("texture") for s in members])):
            if params.rdo_uastc_quality > 0.0:
                ub = uastc_pack.rdo_selector_match(
                    ub, s["px"], params.rdo_uastc_quality,
                    dict_size=params.rdo_uastc_dict_size)
            s["data"] = ub.tobytes()


def _compress_uastc(images, params: CompressorParams) -> CompressorOutput:
    """UASTC LDR 4x4: per-slice raw UASTC blocks (8 bpp); the slice CRC is
    over the block bytes; KTX2 levels are Zstandard-supercompressed where
    `zstandard` is installed."""
    slices, any_alpha = _prep_uastc_slices(images, params)
    _encode_uastc_slices(slices, params)
    return _assemble_uastc(slices, any_alpha, params)


def _compress_uastc_batch(images, params: CompressorParams):
    """N UASTC textures, one CompressorOutput per input image."""
    with telemetry.span("uastc.prep"):
        preps = [_prep_uastc_slices([img], params) for img in images]
    for i, (sl, _) in enumerate(preps):
        for s in sl:
            s["texture"] = i
    _encode_uastc_slices([s for sl, _ in preps for s in sl], params)
    out = []
    for i, (sl, a) in enumerate(preps):
        with telemetry.span("uastc.container", texture=i):
            out.append(_assemble_uastc(sl, a, params))
    return out


def _assemble_uastc(slices, any_alpha: bool,
                    params: CompressorParams) -> CompressorOutput:
    descs = []
    for s in slices:
        descs.append(basis_file.SliceDesc(
            image_index=s["image_index"], level_index=s["level_index"],
            flags=int(SliceDescFlags.HAS_ALPHA) if s["alpha"] else 0,
            orig_width=s["orig_width"], orig_height=s["orig_height"],
            num_blocks_x=s["num_blocks_x"], num_blocks_y=s["num_blocks_y"],
            slice_data_crc16=crc16(s["data"]),
        ))
    flags = 0
    if params.perceptual:
        flags |= HeaderFlags.SRGB
    if any_alpha:
        flags |= HeaderFlags.HAS_ALPHA_SLICES
    data = basis_file.write_basis_file(
        BasisTexFormat.UASTC_LDR_4x4, descs, [s["data"] for s in slices],
        tex_type=params.tex_type, flags=int(flags),
        userdata0=params.userdata0, userdata1=params.userdata1)

    base = slices[0]
    level_count, layer_count, face_count, info = _ktx2_layout(params, slices)
    ktx2_data = ktx2.write_ktx2_uastc(
        base_width=base["orig_width"], base_height=base["orig_height"],
        level_count=level_count,
        layer_count=layer_count,
        face_count=face_count,
        slice_blocks=[s["data"] for s in slices],
        slice_info=info,
        srgb=params.perceptual, has_alpha=any_alpha)
    return CompressorOutput(
        basis_data=data, ktx2_data=ktx2_data,
        num_endpoints=0, num_selectors=0,
        slice_endpoints=[], slice_selectors=[])


def _compress_astc_ldr(images, params: CompressorParams,
                       bw: int = 4, bh: int = 4) -> CompressorOutput:
    """ASTC LDR 4x4-12x12: 4x4 runs the UASTC mode search (on
    `params.device`) + byte-exact
    repack; other footprints run the direct CEM 8/12 encoder
    (codecs/astc/ldr_encode.py). Raw 16-byte blocks per slice, Zstd KTX2
    with VkFormat ASTC_<WxH>_UNORM/SRGB)."""
    from .codecs.astc import ldr_encode
    from .codecs.uastc import astc_pack
    from .ops.resample import generate_mipmaps

    slices = []
    any_alpha = False
    for image_index, img in enumerate(images):
        img = np.asarray(img)
        if img.ndim == 2:
            img = img[..., None].repeat(3, axis=-1)
        if img.shape[-1] == 3:
            img = np.concatenate(
                [img, np.full(img.shape[:2] + (1,), 255, np.uint8)], axis=-1)
        has_alpha = bool((img[..., 3] != 255).any())
        any_alpha |= has_alpha
        levels = [img]
        if params.mip_gen:
            levels += generate_mipmaps(
                img, params.mip_smallest_dimension,
                filter=params.mip_filter, srgb=params.mip_srgb,
                premultiplied=params.mip_premultiplied,
                renormalize=params.mip_renormalize,
                wrap=params.mip_wrapping)
        for level_index, lvl in enumerate(levels):
            h, w = lvl.shape[:2]
            by, bx = -(-h // bh), -(-w // bw)
            if (bw, bh) == (4, 4):
                from .codecs.astc import refine as astc_refine

                blocks = image_to_blocks(lvl).astype(np.float32)
                ub = uastc_encode.encode_blocks(
                    blocks.reshape(by * bx, 16, 4), effort=params.effort,
                    has_alpha=has_alpha, device=params.device)
                astc = astc_pack.uastc_blocks_to_astc(ub)
                # the UASTC search scored under UASTC decode semantics;
                # re-pick weights under the true ASTC decode (sRGB expands
                # endpoints |0x80) now that the blocks are plain ASTC
                astc = astc_refine.refine_astc_blocks(
                    astc, blocks.reshape(by * bx, 16, 4).astype(np.uint8),
                    4, 4, srgb=params.perceptual)
            else:
                pad = np.zeros((by * bh, bx * bw, 4), dtype=np.uint8)
                pad[:h, :w] = lvl
                if h < pad.shape[0]:
                    pad[h:] = pad[h - 1:h]
                if w < pad.shape[1]:
                    pad[:, w:] = pad[:, w - 1:w]
                pb = pad.reshape(by, bh, bx, bw, 4).transpose(0, 2, 1, 3, 4)
                astc = ldr_encode.encode_blocks_ldr(
                    pb.reshape(by * bx, bh * bw, 4), bw, bh,
                    has_alpha=has_alpha, effort=params.effort,
                    scd_grid=(bx, by), srgb=params.perceptual)
            slices.append(dict(
                image_index=image_index, level_index=level_index,
                orig_width=w, orig_height=h, num_blocks_x=bx,
                num_blocks_y=by, alpha=has_alpha, data=astc.tobytes()))

    descs = []
    for s in slices:
        descs.append(basis_file.SliceDesc(
            image_index=s["image_index"], level_index=s["level_index"],
            flags=int(SliceDescFlags.HAS_ALPHA) if s["alpha"] else 0,
            orig_width=s["orig_width"], orig_height=s["orig_height"],
            num_blocks_x=s["num_blocks_x"], num_blocks_y=s["num_blocks_y"],
            slice_data_crc16=crc16(s["data"]),
        ))
    flags = 0
    if params.perceptual:
        flags |= HeaderFlags.SRGB
    if any_alpha:
        flags |= HeaderFlags.HAS_ALPHA_SLICES
    data = basis_file.write_basis_file(
        params.tex_format, descs, [s["data"] for s in slices],
        tex_type=params.tex_type, flags=int(flags),
        userdata0=params.userdata0, userdata1=params.userdata1)
    base = slices[0]
    level_count, layer_count, face_count, info = _ktx2_layout(params, slices)
    ktx2_data = ktx2.write_ktx2_astc(
        base_width=base["orig_width"], base_height=base["orig_height"],
        level_count=level_count, layer_count=layer_count,
        face_count=face_count,
        slice_blocks=[s["data"] for s in slices],
        slice_info=info,
        block_w=bw, block_h=bh, srgb=params.perceptual)
    return CompressorOutput(
        basis_data=data, ktx2_data=ktx2_data,
        num_endpoints=0, num_selectors=0,
        slice_endpoints=[], slice_selectors=[])


def _xu_encode_slices(images, params: CompressorParams, encode_fn,
                      bw: int, bh: int):
    """Shared XUASTC/XUBC7 slice assembly: each image is a layer, mip_gen
    adds levels; encode_fn(img_rgba, has_alpha) -> stream bytes."""
    from .ops.resample import generate_mipmaps

    slices = []
    for image_index, img in enumerate(images):
        img = np.asarray(img)
        if img.ndim == 2:
            img = img[..., None].repeat(3, axis=-1)
        if img.shape[-1] == 3:
            img = np.concatenate(
                [img, np.full(img.shape[:2] + (1,), 255, np.uint8)], axis=-1)
        levels = [img]
        if params.mip_gen:
            levels += generate_mipmaps(
                img, params.mip_smallest_dimension,
                filter=params.mip_filter, srgb=params.mip_srgb,
                premultiplied=params.mip_premultiplied,
                renormalize=params.mip_renormalize,
                wrap=params.mip_wrapping)
        for level_index, lvl in enumerate(levels):
            has_alpha = bool((lvl[..., 3] != 255).any())
            h, w = lvl.shape[:2]
            slices.append(dict(
                image_index=image_index, level_index=level_index,
                orig_width=w, orig_height=h,
                num_blocks_x=-(-w // bw), num_blocks_y=-(-h // bh),
                alpha=has_alpha, data=encode_fn(lvl, has_alpha)))
    return slices


def _xu_basis_slices(slices, params: CompressorParams):
    """Slice dicts -> (.basis SliceDescs, streams, header flags)."""
    descs, streams = [], []
    any_alpha = False
    for s in slices:
        descs.append(basis_file.SliceDesc(
            image_index=s["image_index"], level_index=s["level_index"],
            flags=int(SliceDescFlags.HAS_ALPHA) if s["alpha"] else 0,
            orig_width=s["orig_width"], orig_height=s["orig_height"],
            num_blocks_x=s["num_blocks_x"], num_blocks_y=s["num_blocks_y"],
            slice_data_crc16=crc16(s["data"])))
        streams.append(s["data"])
        any_alpha |= s["alpha"]
    flags = 0
    if params.perceptual:
        flags |= HeaderFlags.SRGB
    if any_alpha:
        flags |= HeaderFlags.HAS_ALPHA_SLICES
    return descs, streams, flags


def _compress_xuastc_ldr(images, params: CompressorParams,
                         bw: int, bh: int) -> CompressorOutput:
    """XUASTC LDR (supercompressed ASTC): the direct ASTC candidate search
    plus the XUASTC entropy layer (codecs/astc/xuastc_encode.py, parity:
    the reference's astc_ldr_t encoder, encoder/basisu_astc_ldr_encode.cpp).
    Layers (multiple images), mips, and cubemaps map to per-slice streams
    with level-major SGD descs. quality_level 1-99 enables the weight-grid
    DCT at that quality; 100 or out-of-range means lossless (the reference's
    unified-quality gate, encoder/basisu_comp.cpp:236-249)."""
    from .codecs.astc import xuastc_encode

    q = params.quality_level
    # DCT quality calibration: our solid-RDO pass frees ~15% rate vs the
    # reference at equal dct_quality, so spend it on a gentler weight DCT
    # (measured on the kodim parity grid: at q25 we are -16% size; +12
    # internal steps re-lands on the reference's RD curve, tapering off
    # as the DCT approaches lossless)
    bump = 12 if q <= 60 else (8 if q <= 80 else (4 if q <= 92 else 0))
    dct_q = float(min(q + bump, 99)) if 1 <= q <= 99 else None
    slices = _xu_encode_slices(
        images, params,
        lambda img, ha: xuastc_encode.encode_image(
            img, bw, bh, has_alpha=ha, srgb=params.perceptual,
            effort=params.effort, dct_quality=dct_q,
            rdo_quality=float(q) if 1 <= q <= 99 else None,
            syntax=params.xuastc_syntax, device=params.device),
        bw, bh)
    descs, streams, flags = _xu_basis_slices(slices, params)
    data = basis_file.write_basis_file(
        params.tex_format, descs, streams,
        tex_type=params.tex_type, flags=int(flags),
        userdata0=params.userdata0, userdata1=params.userdata1)
    base = slices[0]
    level_count, layer_count, face_count, info = _ktx2_layout(params, slices)
    order = sorted(range(len(slices)),
                   key=lambda i: (info[i]["level"], info[i]["layer"],
                                  info[i]["face"]))
    ktx2_data = ktx2.write_ktx2_xuastc(
        base_width=base["orig_width"], base_height=base["orig_height"],
        block_w=bw, block_h=bh, srgb=params.perceptual,
        slice_blocks=[slices[i]["data"] for i in order],
        slice_info=[info[i] for i in order],
        level_count=level_count, layer_count=layer_count,
        face_count=face_count)
    return CompressorOutput(
        basis_data=data, ktx2_data=ktx2_data,
        num_endpoints=0, num_selectors=0,
        slice_endpoints=[], slice_selectors=[])


def _compress_xubc7(images, params: CompressorParams) -> CompressorOutput:
    """XUBC7 (supercompressed BC7): RGBA -> all-mode BC7 source encode
    (codecs/bc7/encode.py, the bc7e analog — modes 1/5/6/7 batched device
    search) -> lossless XUBC7 blob stream (codecs/bc7/xbc7_encode.py,
    parity: the reference's xbc7 encoder, which feeds bc7e blocks —
    encoder/basisu_xbc7_encode.cpp; the stream decodes byte-exact to the
    BC7 input). effort 0 falls back to the fast mode-5 realtime encoder
    (ops/transcode.py). quality_level 1-99 enables the lossy weight-grid
    DCT (m_dct_q, encoder/basisu_xbc7_encode.h:31); 100/out-of-range is
    lossless. Layers/mips/cubemaps map to per-slice streams with
    level-major SGD descs."""
    from .codecs.bc7 import xbc7_encode

    q = params.quality_level
    dct_q = int(q) if 1 <= q <= 99 else 100

    def encode_one(img, has_alpha):
        h, w = img.shape[:2]
        blocks = image_to_blocks(img)
        px = blocks.reshape(-1, 16, 4)
        if params.effort <= 0:
            from .ops import transcode as tc_ops
            bc7 = np.asarray(
                tc_ops.rgba_blocks_to_bc7_m5(px.astype(np.float64)),
                np.uint8).reshape(-1, 16)
        else:
            from .codecs.bc7 import encode as bc7_encode
            # lossy (dct_q < 100): single-subset mode-5/6 base blocks, the
            # bc7f operating point the reference feeds its lossy path
            # (basisu_comp.cpp:1852-1876 picks bc7f at these settings) —
            # partition modes buy fidelity the weight-DCT then discards,
            # at ~2x the endpoint rate. Measured on kodim23 q50: 5/6-base
            # is -24% size AND within 0.4 dB of the all-mode base.
            bc7 = bc7_encode.encode_blocks(
                px.astype(np.uint8), effort=params.effort,
                perceptual=params.perceptual,
                modes=(5, 6) if dct_q < 100 else None,
                device=params.device)
        rdo = None
        if params.xubc7_rdo_level:
            rdo = xbc7_encode.RdoOptions.from_level(
                params.xubc7_rdo_level, perceptual=params.perceptual)
        return xbc7_encode.encode_blocks(
            bc7, w, h, quality=dct_q, src_pixels=px.astype(np.uint8),
            rdo=rdo, effort=params.effort)

    slices = _xu_encode_slices(images, params, encode_one, 4, 4)
    descs, streams, flags = _xu_basis_slices(slices, params)
    data = basis_file.write_basis_file(
        params.tex_format, descs, streams,
        tex_type=params.tex_type, flags=int(flags),
        userdata0=params.userdata0, userdata1=params.userdata1)
    base = slices[0]
    level_count, layer_count, face_count, info = _ktx2_layout(params, slices)
    order = sorted(range(len(slices)),
                   key=lambda i: (info[i]["level"], info[i]["layer"],
                                  info[i]["face"]))
    ktx2_data = ktx2.write_ktx2_xubc7(
        base_width=base["orig_width"], base_height=base["orig_height"],
        srgb=params.perceptual,
        slice_blocks=[slices[i]["data"] for i in order],
        slice_info=[info[i] for i in order],
        level_count=level_count, layer_count=layer_count,
        face_count=face_count)
    return CompressorOutput(
        basis_data=data, ktx2_data=ktx2_data,
        num_endpoints=0, num_selectors=0,
        slice_endpoints=[], slice_selectors=[])


def _compress_astc_hdr_6x6(images, params: CompressorParams) -> CompressorOutput:
    """ASTC HDR 6x6: float32 RGB (linear) inputs -> standard ASTC HDR 6x6
    blocks (CEM 11, 5x5 weight grid), .basis + Zstd KTX2 (VkFormat
    ASTC_6x6_SFLOAT)."""
    from .codecs.astc import hdr_encode
    from .ops.resample import generate_mipmaps_hdr

    slices = []
    for image_index, img in enumerate(images):
        img = np.asarray(img, dtype=np.float32)
        if img.ndim == 2:
            img = img[..., None].repeat(3, axis=-1)
        levels = [img[..., :3]]
        if params.mip_gen:
            levels += generate_mipmaps_hdr(
                img[..., :3], params.mip_smallest_dimension)
        for level_index, lvl in enumerate(levels):
            half = hdr_encode.float_to_half_bits(lvl).view(np.uint16)
            h, w = lvl.shape[:2]
            by, bx = -(-h // 6), -(-w // 6)
            pad = np.zeros((by * 6, bx * 6, 3), dtype=np.uint16)
            pad[:h, :w] = half
            if h < pad.shape[0]:
                pad[h:] = pad[h - 1:h]
            if w < pad.shape[1]:
                pad[:, w:] = pad[:, w - 1:w]
            blocks = pad.reshape(by, 6, bx, 6, 3).transpose(0, 2, 1, 3, 4)
            ub = hdr_encode.encode_blocks_hdr_6x6(
                blocks.reshape(by * bx, 36, 3), effort=params.effort,
                quality=params.quality_level, nbx=bx)
            slices.append(dict(
                image_index=image_index, level_index=level_index,
                orig_width=w, orig_height=h, num_blocks_x=bx,
                num_blocks_y=by, alpha=False, data=ub.tobytes()))

    descs = [basis_file.SliceDesc(
        image_index=s["image_index"], level_index=s["level_index"], flags=0,
        orig_width=s["orig_width"], orig_height=s["orig_height"],
        num_blocks_x=s["num_blocks_x"], num_blocks_y=s["num_blocks_y"],
        slice_data_crc16=crc16(s["data"])) for s in slices]
    data = basis_file.write_basis_file(
        BasisTexFormat.ASTC_HDR_6x6, descs, [s["data"] for s in slices],
        tex_type=params.tex_type, flags=0,
        userdata0=params.userdata0, userdata1=params.userdata1)
    base = slices[0]
    level_count, layer_count, face_count, info = _ktx2_layout(params, slices)
    ktx2_data = ktx2.write_ktx2_astc(
        base_width=base["orig_width"], base_height=base["orig_height"],
        level_count=level_count, layer_count=layer_count,
        face_count=face_count,
        slice_blocks=[s["data"] for s in slices],
        slice_info=info,
        block_w=6, block_h=6, srgb=False, hdr=True)
    return CompressorOutput(
        basis_data=data, ktx2_data=ktx2_data,
        num_endpoints=0, num_selectors=0,
        slice_endpoints=[], slice_selectors=[])


def _compress_uastc_hdr_6x6i(images, params: CompressorParams) -> CompressorOutput:
    """UASTC HDR 6x6 intermediate: float32 RGB -> supercompressed stream
    (.basis tex_format 4, KTX2 scheme 4 / model 168)."""
    from .codecs.astc import hdr6x6_decode as hd
    from .codecs.astc import hdr_encode

    if params.tex_type == BasisTextureType.CUBEMAP_ARRAY:
        raise ValueError(
            "UASTC HDR 6x6 intermediate does not support cubemap arrays")
    img = np.asarray(images[0], dtype=np.float32)
    if img.ndim == 2:
        img = img[..., None].repeat(3, axis=-1)
    half = hdr_encode.float_to_half_bits(img[..., :3]).view(np.uint16)
    h, w = img.shape[:2]
    by, bx = -(-h // 6), -(-w // 6)
    pad = np.zeros((by * 6, bx * 6, 3), dtype=np.uint16)
    pad[:h, :w] = half
    if h < pad.shape[0]:
        pad[h:] = pad[h - 1:h]
    if w < pad.shape[1]:
        pad[:, w:] = pad[:, w - 1:w]
    blocks = pad.reshape(by, 6, bx, 6, 3).transpose(0, 2, 1, 3, 4)
    stream = hd.encode_6x6_hdr(
        blocks.reshape(by * bx, 36, 3), w, h, effort=params.effort,
        quality=params.quality_level)
    descs = [basis_file.SliceDesc(
        image_index=0, level_index=0, flags=0,
        orig_width=w, orig_height=h, num_blocks_x=bx, num_blocks_y=by,
        slice_data_crc16=crc16(stream))]
    data = basis_file.write_basis_file(
        BasisTexFormat.UASTC_HDR_6x6_INTERMEDIATE, descs, [stream],
        tex_type=params.tex_type, flags=0,
        userdata0=params.userdata0, userdata1=params.userdata1)
    ktx2_data = ktx2.write_ktx2_uastc_hdr_6x6i(
        base_width=w, base_height=h, stream=stream)
    return CompressorOutput(
        basis_data=data, ktx2_data=ktx2_data,
        num_endpoints=0, num_selectors=0,
        slice_endpoints=[], slice_selectors=[])


def _compress_uastc_hdr(images, params: CompressorParams) -> CompressorOutput:
    """UASTC HDR 4x4: float32 RGB (linear) inputs -> standard constrained
    ASTC HDR blocks (CEM 11), .basis + Zstd KTX2 (model 167)."""
    from .codecs.astc import hdr_encode

    from .ops.resample import generate_mipmaps_hdr

    slices = []
    for image_index, img in enumerate(images):
        img = np.asarray(img, dtype=np.float32)
        if img.ndim == 2:
            img = img[..., None].repeat(3, axis=-1)
        levels = [img[..., :3]]
        if params.mip_gen:
            levels += generate_mipmaps_hdr(
                img[..., :3], params.mip_smallest_dimension)
        for level_index, lvl in enumerate(levels):
            half = hdr_encode.float_to_half_bits(lvl)
            h, w = lvl.shape[:2]
            blocks = image_to_blocks(half.view(np.uint16)).astype(np.uint16)
            by, bx = blocks.shape[:2]
            ub = hdr_encode.encode_blocks_hdr(
                blocks.reshape(by * bx, 16, 3), effort=params.effort)
            slices.append(dict(
                image_index=image_index, level_index=level_index,
                orig_width=w, orig_height=h, num_blocks_x=bx,
                num_blocks_y=by, alpha=False, data=ub.tobytes()))

    descs = [basis_file.SliceDesc(
        image_index=s["image_index"], level_index=s["level_index"], flags=0,
        orig_width=s["orig_width"], orig_height=s["orig_height"],
        num_blocks_x=s["num_blocks_x"], num_blocks_y=s["num_blocks_y"],
        slice_data_crc16=crc16(s["data"])) for s in slices]
    data = basis_file.write_basis_file(
        BasisTexFormat.UASTC_HDR_4x4, descs, [s["data"] for s in slices],
        tex_type=params.tex_type, flags=0,
        userdata0=params.userdata0, userdata1=params.userdata1)

    base = slices[0]
    level_count, layer_count, face_count, info = _ktx2_layout(params, slices)
    ktx2_data = ktx2.write_ktx2_uastc_hdr(
        base_width=base["orig_width"], base_height=base["orig_height"],
        level_count=level_count, layer_count=layer_count,
        face_count=face_count,
        slice_blocks=[s["data"] for s in slices],
        slice_info=info)
    return CompressorOutput(
        basis_data=data, ktx2_data=ktx2_data,
        num_endpoints=0, num_selectors=0,
        slice_endpoints=[], slice_selectors=[])


def _ofs(slices, i):
    """Flat-index slice of concatenated per-slice block arrays."""
    start = sum(s["blocks"].shape[0] for s in slices[:i])
    return slice(start, start + slices[i]["blocks"].shape[0])


def _assemble(slices, fe, params: CompressorParams,
              use_global: bool = False) -> CompressorOutput:
    is_video = params.tex_type == BasisTextureType.VIDEO_FRAMES
    e_t, s_t = _rdo_thresholds(params)
    use_rdo = (not use_global and not is_video and params.effort >= 1
               and native_mod.available())

    if use_rdo:
        with telemetry.span("etc1s.assembly.rdo"):
            (tables, slice_streams, e_color5, e_inten, sel_cb, e_grids,
             s_grids) = etc1s_backend.encode_slices_rdo(
                [s["blocks"] for s in slices],
                [fe.block_endpoints[_ofs(slices, i)].reshape(
                    slices[i]["num_blocks_y"], slices[i]["num_blocks_x"])
                 for i in range(len(slices))],
                [fe.block_selectors[_ofs(slices, i)].reshape(
                    slices[i]["num_blocks_y"], slices[i]["num_blocks_x"])
                 for i in range(len(slices))],
                fe.endpoint_color5, fe.endpoint_inten5, fe.selectors,
                e_thresh=e_t, s_thresh=s_t,
                comp_level=min(params.effort, 6),
                perceptual=params.perceptual_metric)
    else:
        if use_global:
            e_color5, e_inten, block_e = (
                fe.endpoint_color5, fe.endpoint_inten5, fe.block_endpoints)
            sel_cb, block_s = fe.selectors, fe.block_selectors
        else:
            e_color5, e_inten, block_e = etc1s_backend.sort_endpoint_palette(
                fe.endpoint_color5, fe.endpoint_inten5, fe.block_endpoints)
            sel_cb, block_s = etc1s_backend.sort_selector_palette(
                fe.selectors, fe.block_selectors)

        e_grids, s_grids = [], []
        ofs = 0
        for s in slices:
            n = s["blocks"].shape[0]
            shape = (s["num_blocks_y"], s["num_blocks_x"])
            e_grids.append(block_e[ofs:ofs + n].reshape(shape))
            s_grids.append(block_s[ofs:ofs + n].reshape(shape))
            ofs += n

    with telemetry.span("etc1s.assembly.palettes"):
        endpoint_palette = etc1s_backend.encode_endpoint_palette(e_color5,
                                                                 e_inten)
        selector_palette = etc1s_backend.encode_selector_palette(sel_cb)

    # video frames: P-frames use conditional replenishment vs the previous
    # frame's slice of the same (level, alpha) kind
    video_prev = None
    if is_video:
        video_prev = []
        last_by_kind = {}
        for i, s in enumerate(slices):
            kind = (s["level_index"], s["alpha"])
            video_prev.append(last_by_kind.get(kind))
            last_by_kind[kind] = i

    if not use_rdo:
        tables, slice_streams = etc1s_backend.encode_slices(
            e_grids, s_grids, e_color5.shape[0], sel_cb.shape[0],
            video_prev=video_prev)

    with telemetry.span("etc1s.assembly.pack"):
        descs = []
        any_alpha = False
        for i, (s, e_grid, s_grid) in enumerate(
                zip(slices, e_grids, s_grids)):
            physical = pack_etc1_blocks(e_grid, s_grid, e_color5, e_inten,
                                        sel_cb)
            sflags = 0
            if s["alpha"]:
                sflags |= SliceDescFlags.HAS_ALPHA
                any_alpha = True
            if is_video and (video_prev[i] is None):
                sflags |= SliceDescFlags.FRAME_IS_IFRAME
            descs.append(basis_file.SliceDesc(
                image_index=s["image_index"],
                level_index=s["level_index"],
                flags=int(sflags),
                orig_width=s["orig_width"],
                orig_height=s["orig_height"],
                num_blocks_x=s["num_blocks_x"],
                num_blocks_y=s["num_blocks_y"],
                slice_data_crc16=crc16(physical.tobytes()),
            ))

    with telemetry.span("etc1s.assembly.write"):
        flags = HeaderFlags.ETC1S
        if params.perceptual:
            flags |= HeaderFlags.SRGB
        if any_alpha:
            flags |= HeaderFlags.HAS_ALPHA_SLICES
        if use_global:
            flags |= HeaderFlags.USES_GLOBAL_CODEBOOK

        data = basis_file.write_basis_file(
            BasisTexFormat.ETC1S, descs, slice_streams,
            endpoint_palette=b"" if use_global else endpoint_palette,
            selector_palette=b"" if use_global else selector_palette,
            tables=tables,
            num_endpoints=e_color5.shape[0],
            num_selectors=sel_cb.shape[0],
            tex_type=params.tex_type,
            flags=int(flags),
            us_per_frame=params.us_per_frame if is_video else 0,
            userdata0=params.userdata0,
            userdata1=params.userdata1,
        )

        base = slices[0]
        level_count, layer_count, face_count, info = _ktx2_layout(params,
                                                                  slices)
        for i, s in enumerate(slices):
            info[i]["alpha"] = s["alpha"]
            info[i]["iframe"] = (not is_video) or video_prev[i] is None
        ktx2_data = ktx2.write_ktx2_etc1s(
            base_width=base["orig_width"], base_height=base["orig_height"],
            level_count=level_count, layer_count=layer_count,
            face_count=face_count,
            slice_streams=slice_streams,
            slice_info=info,
            is_video=is_video,
            endpoint_palette=endpoint_palette,
            selector_palette=selector_palette,
            tables=tables,
            num_endpoints=e_color5.shape[0],
            num_selectors=sel_cb.shape[0],
            srgb=params.perceptual,
            has_alpha=any_alpha,
        )
    return CompressorOutput(
        basis_data=data,
        ktx2_data=ktx2_data,
        num_endpoints=e_color5.shape[0],
        num_selectors=sel_cb.shape[0],
        slice_endpoints=e_grids,
        slice_selectors=s_grids,
    )
