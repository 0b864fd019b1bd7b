"""The yardstick of a texture's decoded error: every 4x4 block encoded on
its own as an ETC1S block (one 5:5:5 base colour, the block mean's, one of
the 8 intensity tables, the nearest of its 4 colours for each texel), in
plain PyTorch.

No codebook limits it, so at the same base colour it is the best an ETC1S
block can do: a codebook encoder's error is a multiple of it, and a UASTC
block's a fraction."""

import torch

ETC1_INTEN_TABLES = ((-8, -2, 2, 8), (-17, -5, 5, 17), (-29, -9, 9, 29),
                     (-42, -13, 13, 42), (-60, -18, 18, 60),
                     (-80, -24, 24, 80), (-106, -33, 33, 106),
                     (-183, -47, 47, 183))


def blocks(img: torch.Tensor) -> torch.Tensor:
    """(H, W, C) with H and W multiples of 4 -> (H/4 * W/4, 16, C) blocks
    in row order, texels y * 4 + x."""
    h, w, c = img.shape
    if h % 4 or w % 4:
        raise ValueError(f"a {w}x{h} texture: sides must be multiples of 4")
    return img.reshape(h // 4, 4, w // 4, 4, c).permute(
        0, 2, 1, 3, 4).reshape(-1, 16, c)


def block_sq_error(px: torch.Tensor) -> torch.Tensor:
    """px: (N, 16, 3) float32 texels. Each block's least summed squared
    error over the 8 tables at its mean's 5:5:5 base colour, (N,) float64
    (texels are whole numbers, so each block's sum is exact)."""
    base5 = torch.clamp(torch.round(px.mean(1) * (31.0 / 255.0)), 0, 31)
    base8 = base5 * 8.0 + torch.floor(base5 / 4.0)            # (c<<3)|(c>>2)
    best = None
    for table in ETC1_INTEN_TABLES:
        mods = torch.tensor(table, dtype=px.dtype, device=px.device)
        pal = torch.clamp(base8[:, None, :] + mods[None, :, None], 0, 255)
        d = ((px[:, :, None, :] - pal[:, None, :, :]) ** 2).sum(-1)
        err = d.min(-1).values.sum(-1).double()
        best = err if best is None else torch.minimum(best, err)
    return best


def texture_block_errors(img: torch.Tensor, chunk: int = 1 << 16):
    """Each block's squared error under the per-block encode of an (H, W,
    3 | 4) uint8 texture, (H/4 * W/4,) float64 in row order: over its RGB
    channels and, where it has one, its alpha, which is encoded as its own
    (a, a, a) blocks, as ETC1S encodes it, and counted on one channel (the
    three are equal)."""
    h, w, c = img.shape
    x = img.float()
    planes = [(x[..., :3], 1.0)]
    if c == 4:
        planes.append((x[..., 3:4].expand(h, w, 3), 1.0 / 3.0))
    total = None
    for plane, weight in planes:
        b = blocks(plane.contiguous())
        err = torch.cat([block_sq_error(b[i:i + chunk])
                         for i in range(0, b.shape[0], chunk)]) * weight
        total = err if total is None else total + err
    return total
