"""basis_compressor equivalent for ETC1S and UASTC LDR 4x4: image(s) ->
.basis/.KTX2 bytes.

Counterpart of the ETC1S and UASTC LDR 4x4 parts of
`basis_universal_tpu/compressor.py`: read sources -> mipmaps -> extract
blocks -> device search (PyTorch on `device`: the ETC1S frontend, or the
UASTC mode search) -> host stages (ETC1S entropy coding, native when
available; UASTC block packing and RDO) -> container writers. The host
stages are the reference's own modules where they are jax-free, imported;
the functions below are copies of the reference's helpers (that module
imports the JAX frontend at the top). Other texture formats are not ported
yet and raise NotImplementedError.
"""

import concurrent.futures as cf
import dataclasses
from typing import List, Optional, Sequence

import numpy as np

from basis_universal_tpu import native as native_mod
from basis_universal_tpu.codecs.etc1s import backend as etc1s_backend
from basis_universal_tpu.formats import basis_file, ktx2
from basis_universal_tpu.formats.constants import (
    BasisTexFormat,
    BasisTextureType,
    HeaderFlags,
    SliceDescFlags,
)
from basis_universal_tpu.ops.etc1 import image_to_blocks, pack_etc1_blocks
from basis_universal_tpu.utils.crc import crc16

from .codecs.etc1s import frontend as etc1s_frontend
from .codecs.uastc import encode as uastc_encode
from .codecs.uastc import pack as uastc_pack

MAX_ENDPOINT_CLUSTERS = 16128
MAX_SELECTOR_CLUSTERS = 16128

# where each texture format not yet ported stands in ROADMAP.md
_NOT_PORTED = {
    BasisTexFormat.XUBC7: "queue 1, item 8 (BC7 search / XUBC7)",
}
_OTHER_FORMATS = "queue 1, item 12 (the remaining compressor modes)"


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
    seed: int = 0
    # torch device of the frontend
    device: str = "cuda"


@dataclasses.dataclass
class CompressorOutput:
    basis_data: bytes
    ktx2_data: bytes
    num_endpoints: int
    num_selectors: int
    slice_endpoints: List[np.ndarray]
    slice_selectors: List[np.ndarray]


def _require_ported(params: CompressorParams):
    if params.tex_format not in (BasisTexFormat.ETC1S,
                                 BasisTexFormat.UASTC_LDR_4x4):
        where = _NOT_PORTED.get(params.tex_format, _OTHER_FORMATS)
        raise NotImplementedError(
            f"{params.tex_format!r} encoding is not ported to PyTorch yet "
            f"(ROADMAP.md {where})")


def _prepare_slices(images: Sequence[np.ndarray], params: CompressorParams):
    """images -> per-slice dicts. Alpha sources produce two ETC1S slices per
    level: RGB and an (a,a,a) grayscale alpha slice."""
    from basis_universal_tpu.ops.resample import generate_mipmaps

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
    """Encode RGB(A) uint8 image(s) to ETC1S or UASTC LDR 4x4 .basis/.KTX2."""
    _require_ported(params)
    if isinstance(images, np.ndarray):
        images = [images]
    if params.tex_format == BasisTexFormat.UASTC_LDR_4x4:
        return _compress_uastc(images, params)
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
    UASTC groups same-shaped slices across images instead."""
    _require_ported(params)
    if params.tex_format == BasisTexFormat.UASTC_LDR_4x4:
        return _compress_uastc_batch(images, params)
    per_image = [_prepare_slices([img], params) for img in images]
    shapes = {tuple((s["num_blocks_x"] * s["num_blocks_y"], s["alpha"])
                    for s in sl) for sl in per_image}
    if len(shapes) != 1:
        return [compress(img, params) for img in images]
    total_blocks = sum(s["blocks"].shape[0] for s in per_image[0])
    fp = _frontend_params(params, total_blocks)
    batch = [np.concatenate([s["blocks"] for s in sl], axis=0)
             for sl in per_image]
    nbrs = [_slice_neighbors(sl) for sl in per_image]
    with cf.ThreadPoolExecutor(8) as ex:
        futs = [
            ex.submit(_assemble, sl, fe, params)
            for sl, fe in zip(per_image,
                              etc1s_frontend.compress_batch_iter(
                                  batch, fp, seed=params.seed,
                                  neighbors=nbrs))]
        return [f.result() for f in futs]


def _prep_uastc_slices(images, params: CompressorParams):
    """Per-slice pixel prep for UASTC (no encoding): returns (slices,
    any_alpha) where each slice dict carries its (B,16,4) f32 `px`."""
    from basis_universal_tpu.ops.resample import generate_mipmaps

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
                device=params.device)):
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
    preps = [_prep_uastc_slices([img], params) for img in images]
    _encode_uastc_slices([s for sl, _ in preps for s in sl], params)
    return [_assemble_uastc(sl, a, params) for sl, a in preps]


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
        tables, slice_streams, e_color5, e_inten, sel_cb, e_grids, s_grids = \
            etc1s_backend.encode_slices_rdo(
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

    endpoint_palette = etc1s_backend.encode_endpoint_palette(e_color5, e_inten)
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

    descs = []
    any_alpha = False
    for i, (s, e_grid, s_grid) in enumerate(zip(slices, e_grids, s_grids)):
        physical = pack_etc1_blocks(e_grid, s_grid, e_color5, e_inten, sel_cb)
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
    level_count, layer_count, face_count, info = _ktx2_layout(params, slices)
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
