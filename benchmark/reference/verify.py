"""Judge one encoded texture against its source, in plain NumPy and PyTorch:
whether its .basis and .KTX2 files keep the containers' rules and the
configuration's guarantees, and how far its decoded texels lie from the
source beside the per-block yardstick (`blockref`).

What it reads: the .basis header, its CRC-16s and slice descriptors; for
ETC1S the palettes, the Huffman tables and every slice's symbol stream,
decoded, the physical ETC1 blocks against each slice's CRC-16, and the
codebook sizes against the quality level's; for UASTC every block, its
slice's CRC-16 and each block's mode; the .KTX2 header, its DFD colour
model and the slice data and ETC1S global data it carries, byte for byte
against the .basis file's.
"""

import numpy as np
import torch

from . import blockref, container, etc1s, quality, uastc

FORMATS = {"etc1s": container.FORMAT_ETC1S,
           "uastc": container.FORMAT_UASTC_LDR_4x4}
# The UASTC modes a level 0 or 1 search is limited to (RGB 0, RGBA 10,
# LA 15) and the solid colour (8): every other mode is one the level-2
# search adds (the reference's cUASTCLevel, the port's `_effort_mode_set`).
LEVEL1_MODES = (0, 8, 10, 15)


class Invalid(ValueError):
    """A file that breaks a rule the check holds it to."""


def _require(ok: bool, what: str):
    if not ok:
        raise Invalid(what)


def _decode_etc1s(b: container.Basis, k: container.Ktx2, alpha: bool,
                  quality_level):
    h = b.header
    _require(h["flags"] & container.HEADER_FLAG_ETC1S,
             "ETC1S flag not set")
    _require(not h["flags"] & container.HEADER_FLAG_USES_GLOBAL_CODEBOOK,
             "a global codebook")
    ep, sp = b.section("endpoint_cb"), b.section("selector_cb")
    tb = b.section("tables")
    color5, inten, patterns = etc1s.decode_palettes(
        h["total_endpoints"], ep, h["total_selectors"], sp)
    tables, hist = etc1s.decode_tables(tb)
    planes = []
    for i, s in enumerate(b.slices):
        e_idx, s_idx = etc1s.decode_slice(
            b.slice_data(i), s["num_blocks_x"], s["num_blocks_y"], tables,
            hist, h["total_endpoints"], h["total_selectors"])
        phys = etc1s.physical_blocks(e_idx, s_idx, color5, inten, patterns)
        _require(container.crc16(phys.tobytes()) == s["slice_data_crc16"],
                 f"slice {i} CRC-16 of its ETC1 blocks")
        planes.append(etc1s.texels(e_idx, s_idx, color5, inten, patterns))
    if quality_level is not None:
        n_blocks = sum(s["num_blocks_x"] * s["num_blocks_y"]
                       for s in b.slices)
        max_e, max_s = quality.etc1s_clusters(quality_level, n_blocks)
        _require(h["total_endpoints"] <= max_e
                 and h["total_selectors"] <= max_s,
                 f"{h['total_endpoints']} endpoints and "
                 f"{h['total_selectors']} selectors past quality "
                 f"{quality_level}'s {max_e} and {max_s}")
        shortfall = 100.0 * (1.0 - h["total_selectors"] / max_s)
    else:
        shortfall = None

    _require(k.supercompression == container.KTX2_SS_BASISLZ
             and k.color_model == container.KDF_MODEL_ETC1S,
             "KTX2 supercompression or colour model")
    ne, ns, kep, ksp, ktb, descs = k.etc1s_global_data()
    _require((ne, ns, kep, ksp, ktb) == (h["total_endpoints"],
                                         h["total_selectors"], ep, sp, tb),
             "KTX2 global data differs from the .basis palettes and tables")
    _require(len(descs) == 1, "KTX2 image count")
    level = k.level_data(0)
    _flags, rgb_ofs, rgb_len, a_ofs, a_len = descs[0]
    _require(level[rgb_ofs:rgb_ofs + rgb_len] == b.slice_data(0),
             "KTX2 RGB slice differs from the .basis slice")
    if alpha:
        _require(level[a_ofs:a_ofs + a_len] == b.slice_data(1),
                 "KTX2 alpha slice differs from the .basis slice")
    else:
        _require(a_len == 0, "KTX2 alpha slice of an opaque texture")
    rgb = planes[0]
    out = np.concatenate([rgb, planes[1][..., 1:2]], -1) if alpha else rgb
    return out, shortfall                               # (BY, BX, 16, C)


def _decode_uastc(b: container.Basis, k: container.Ktx2, alpha: bool):
    s = b.slices[0]
    data = b.slice_data(0)
    nbx, nby = s["num_blocks_x"], s["num_blocks_y"]
    _require(len(data) == nbx * nby * 16, "UASTC slice size")
    _require(container.crc16(data) == s["slice_data_crc16"],
             "slice 0 CRC-16 of its UASTC blocks")
    _require(k.supercompression in (container.KTX2_SS_NONE,
                                     container.KTX2_SS_ZSTANDARD)
             and k.color_model == container.KDF_MODEL_UASTC_LDR_4X4,
             "KTX2 supercompression or colour model")
    _require(k.level_data(0) == data, "KTX2 level differs from the .basis "
             "slice")
    blocks = np.frombuffer(data, np.uint8).reshape(-1, 16)
    rgba = uastc.decode_rgba(blocks).reshape(nby, nbx, 16, 4)
    level2 = ~np.isin(uastc.modes(blocks), LEVEL1_MODES)
    return (rgba if alpha else rgba[..., :3]), 100.0 * float(level2.mean())


def judge(texture: np.ndarray, basis: bytes, ktx2: bytes, codec: str,
          quality_level=None, device="cpu") -> dict:
    """One texture's verdict: `valid` (False with `problem` where a rule is
    broken), and `sq_error`, `ref_sq_error` and their `ratio` where the
    file decodes, and `worse_pct`, the share of blocks whose decoded error
    exceeds the yardstick block's, in %; for UASTC `level2_modes_pct`, the
    share of blocks in modes a level 0 or 1 search never picks, in %; for
    ETC1S `codebooks`, the endpoint and selector counts, and
    `selector_shortfall_pct`, how far the selector codebook falls short of
    the quality level's size, in % (the selectors' fills to within a few
    tenths of a percent on the cells' textures; the endpoints' comes out a
    quarter or more short, so it is held only to its upper size).
    texture: (H, W, 3 | 4) uint8 with sides that are multiples of 4;
    codec: the configuration's ("etc1s" or "uastc"); quality_level:
    ETC1S's, for its codebook sizes."""
    h, w, c = texture.shape
    alpha = c == 4 and bool((texture[..., 3] != 255).any())
    out = {"valid": True, "problem": None, "sq_error": None,
           "ref_sq_error": None, "ratio": None, "worse_pct": None,
           "level2_modes_pct": None, "codebooks": None,
           "selector_shortfall_pct": None}
    prog = None
    try:
        b = container.Basis(basis)
        k = container.Ktx2(ktx2)
        hd = b.header
        fmt = hd["tex_format"]
        _require(fmt in FORMATS.values(), f"format {fmt} is not decodable")
        n_slices = 2 if (alpha and fmt == container.FORMAT_ETC1S) else 1
        _require(hd["total_images"] == 1 and hd["total_slices"] == n_slices,
                 "image or slice count")
        _require(bool(hd["flags"] & container.HEADER_FLAG_HAS_ALPHA_SLICES)
                 == alpha, "alpha flag")
        for i, s in enumerate(b.slices):
            alpha_slice = alpha and (i == 1 or fmt != container.FORMAT_ETC1S)
            _require((s["image_index"], s["level_index"], s["orig_width"],
                      s["orig_height"], s["num_blocks_x"], s["num_blocks_y"],
                      bool(s["flags"] & container.SLICE_FLAG_HAS_ALPHA))
                     == (0, 0, w, h, -(-w // 4), -(-h // 4), alpha_slice),
                     f"slice {i} descriptor")
        _require((k.width, k.height, max(1, k.level_count), k.layer_count,
                  k.face_count, k.vk_format) == (w, h, 1, 0, 1, 0),
                 "KTX2 header")
        if fmt == container.FORMAT_ETC1S:
            out["codebooks"] = (hd["total_endpoints"], hd["total_selectors"])
            dec, out["selector_shortfall_pct"] = _decode_etc1s(
                b, k, alpha, quality_level if codec == "etc1s" else None)
        else:
            dec, out["level2_modes_pct"] = _decode_uastc(b, k, alpha)
        src = texture if alpha else texture[..., :3]
        by, bx = dec.shape[:2]
        src_blocks = src.reshape(by, 4, bx, 4, -1).transpose(
            0, 2, 1, 3, 4).reshape(by * bx, 16, -1).astype(np.int64)
        prog = ((dec.reshape(by * bx, 16, -1)[..., :src.shape[-1]].astype(
            np.int64) - src_blocks) ** 2).sum((1, 2))
        _require(fmt == FORMATS[codec], f"format {fmt}, not {codec}")
    except (Invalid, container.FormatError, etc1s.DecodeError,
            uastc.DecodeError) as e:
        out["valid"], out["problem"] = False, str(e)
    except (IndexError, ValueError, KeyError) as e:
        out["valid"], out["problem"] = False, f"unreadable: {e!r}"
    if prog is not None:
        ref = blockref.texture_block_errors(torch.as_tensor(
            np.ascontiguousarray(src)).to(device)).cpu().numpy()
        out["sq_error"] = float(prog.sum())
        out["ref_sq_error"] = float(ref.sum())
        out["ratio"] = out["sq_error"] / max(out["ref_sq_error"], 1.0)
        out["worse_pct"] = 100.0 * float((prog > ref).mean())
    return out
