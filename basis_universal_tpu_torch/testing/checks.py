"""Checks for the port's tests and `chip_smoke.py`: decode an ETC1S or
UASTC LDR 4x4 .basis through the reference package's jax-free host decoders
(checking every CRC), score it with PSNR (numpy), and size the float
tolerance of the factorized scan."""

import numpy as np
import torch

from basis_universal_tpu.codecs.etc1s.stream import (
    decode_palettes,
    decode_slice,
    decode_tables,
)
from basis_universal_tpu.codecs.uastc.decode import decode_rgba
from basis_universal_tpu.formats.basis_file import BasisFile
from basis_universal_tpu.ops.etc1 import (
    blocks_to_image,
    decode_blocks_to_rgba,
    pack_etc1_blocks,
)
from basis_universal_tpu.utils.crc import crc16


def decode_etc1s_basis(data: bytes):
    """Per-slice decoded RGBA images of an ETC1S .basis file. Raises if the
    header/data CRCs or any slice's CRC (over its physical ETC1 blocks) do
    not match."""
    f = BasisFile(data)
    if not f.validate_crcs():
        raise AssertionError("header/data CRC mismatch")
    cb = decode_palettes(f.header.total_endpoints, f.endpoint_cb_data,
                         f.header.total_selectors, f.selector_cb_data)
    tables = decode_tables(f.tables_data)
    images = []
    for i, s in enumerate(f.slices):
        e, sel = decode_slice(f.slice_data(i), s.num_blocks_x, s.num_blocks_y,
                              tables, f.header.total_endpoints,
                              f.header.total_selectors)
        phys = pack_etc1_blocks(e, sel, cb.color5, cb.inten5, cb.selectors)
        if crc16(phys.tobytes()) != s.slice_data_crc16:
            raise AssertionError(f"slice {i} CRC mismatch")
        blocks = decode_blocks_to_rgba(e, sel, cb.color5, cb.inten5,
                                       cb.selectors)
        images.append(blocks_to_image(blocks, s.orig_width, s.orig_height))
    return images


def psnr(a, b) -> float:
    """PSNR in dB of two uint8-range images (99 for identical ones)."""
    mse = np.mean((np.asarray(a, np.float64) - np.asarray(b, np.float64)) ** 2)
    return float(10.0 * np.log10(255.0 ** 2 / mse)) if mse > 0 else 99.0


def etc1s_psnr(data: bytes, image) -> float:
    """PSNR of a .basis file against its source: the RGB slice against the
    RGB channels and, for an RGBA source, the alpha slice against alpha,
    over all channels together."""
    image = np.asarray(image)
    dec = decode_etc1s_basis(data)
    got = [dec[0][..., :3]]
    want = [image[..., :3]]
    if image.shape[-1] == 4 and len(dec) > 1:
        got.append(dec[1][..., :1])
        want.append(image[..., 3:4])
    return psnr(np.concatenate(got, -1), np.concatenate(want, -1))


def decode_uastc_basis(data: bytes):
    """Per-slice decoded RGBA images of a UASTC LDR 4x4 .basis file. Raises
    if the header/data CRCs or any slice's CRC (over its block bytes) do not
    match."""
    f = BasisFile(data)
    if not f.validate_crcs():
        raise AssertionError("header/data CRC mismatch")
    images = []
    for i, s in enumerate(f.slices):
        raw = f.slice_data(i)
        if crc16(raw) != s.slice_data_crc16:
            raise AssertionError(f"slice {i} CRC mismatch")
        blocks = np.frombuffer(raw, dtype=np.uint8).reshape(-1, 16)
        rgba = decode_rgba(blocks).reshape(s.num_blocks_y, s.num_blocks_x, 4,
                                           4, 4)
        images.append(blocks_to_image(rgba, s.orig_width, s.orig_height))
    return images


def uastc_psnr(data: bytes, image) -> float:
    """PSNR of a UASTC .basis file's first slice against its source, over
    RGB, and alpha too for an RGBA source."""
    image = np.asarray(image)
    c = 4 if image.shape[-1] == 4 else 3
    return psnr(decode_uastc_basis(data)[0][..., :c], image[..., :c])


def scan_term_magnitude(pixels, base5=None, radius: int = 1,
                        perceptual: bool = False):
    """(B, D*8) float32: per block and candidate column, the sum of the
    magnitudes of the terms the factorized scan's error formula adds
    (q = sum|x|^2 - 2 e.sum(x) + 16|e|^2, su2/3 likewise for the luma axis).
    They cancel down to the error, so two float32 evaluations in different
    orders differ by a few ulps of this sum, not of the error."""
    from ..ops.cuda_etc1s import C31_255
    from ..ops.etc1s_encode import (PERC_P, _candidate_deltas,
                                    perceptual_transform)

    px = pixels.float()
    deltas = torch.as_tensor(_candidate_deltas(radius), device=px.device)
    b5 = (torch.clamp(torch.round(px.sum(1) / 16.0 * C31_255), 0.0, 31.0)
          if base5 is None else base5.float())
    c5 = torch.clamp(b5[None] + deltas[:, None, :].float(), 0.0, 31.0)
    e = c5 * 8.0 + torch.floor(c5 * 0.25)                    # (D,B,3)
    if perceptual:
        g = torch.as_tensor(PERC_P @ np.ones(3, np.float32), device=px.device)
        px, e = perceptual_transform(px), perceptual_transform(e)
        luma, lb = px @ g, e @ g
    else:
        luma, lb = px.sum(-1), e.sum(-1)
    s = px.sum(1)                                            # (B,3)
    q = ((px * px).sum((1, 2))[None] + 2.0 * (e * s[None]).sum(-1).abs()
         + 16.0 * (e * e).sum(-1))
    su2 = ((luma * luma).sum(-1)[None] + 2.0 * (lb * luma.sum(-1)[None]).abs()
           + 16.0 * lb * lb)
    return (q + su2 / 3.0).T.repeat_interleave(8, dim=1)
