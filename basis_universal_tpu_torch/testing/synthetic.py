"""Structured synthetic RGB(A) textures, built from a seed with numpy only.

Content is a sum of smooth gradients, periodic waves, hard-edged shapes and
mild noise, the mix real texture content has, rather than pure noise (a
degenerate vector-quantiser input). Only `Generator.integers` and
`Generator.uniform` draw random numbers, and the waves use a polynomial
(no transcendental functions), so the same seed gives the same bytes on
every platform and numpy version; `synthetic_texture` returns the sha256 of
what it built so a caller can check that. `uastc_winner_buffer` draws a
UASTC search's winner buffer in which every slot of a slot list wins
blocks, the input the block packing is tested on.
"""

import hashlib

import numpy as np


def _wave(phase):
    """A smooth periodic wave in [-1, 1] of period 1 (a sine look-alike
    built from a triangle wave and a cubic)."""
    p = phase - np.floor(phase)
    tri = 4.0 * np.abs(p - 0.5) - 1.0
    return tri * (1.5 - 0.5 * tri * tri)


def synthetic_texture(height: int, width: int, seed: int = 0,
                      alpha: bool = False):
    """Returns (image (H, W, 3|4) uint8, sha256 hex of its bytes)."""
    rng = np.random.default_rng(seed)
    y = np.arange(height, dtype=np.float64)[:, None] / max(height - 1, 1)
    x = np.arange(width, dtype=np.float64)[None, :] / max(width - 1, 1)
    img = np.zeros((height, width, 3), dtype=np.float64)

    # a few gradients in random directions and colours
    for _ in range(3):
        a, b = rng.uniform(-1.0, 1.0, 2)
        col = rng.uniform(-90.0, 90.0, 3)
        img += (a * x + b * y)[..., None] * col
    img += rng.uniform(60.0, 190.0, 3)

    # periodic waves of several frequencies and orientations
    for _ in range(4):
        fx, fy = rng.uniform(-12.0, 12.0, 2)
        ph = rng.uniform(0.0, 1.0)
        amp = rng.uniform(5.0, 30.0, 3)
        img += _wave(fx * x + fy * y + ph)[..., None] * amp

    # hard-edged rectangles and discs of flat colour
    yy, xx = np.mgrid[0:height, 0:width]
    for _ in range(int(rng.integers(6, 12))):
        col = rng.uniform(0.0, 255.0, 3)
        cy = int(rng.integers(0, height))
        cx = int(rng.integers(0, width))
        ry = int(rng.integers(2, max(3, height // 5)))
        rx = int(rng.integers(2, max(3, width // 5)))
        if rng.integers(0, 2):
            mask = (np.abs(yy - cy) <= ry) & (np.abs(xx - cx) <= rx)
        else:
            mask = ((yy - cy) ** 2) * rx * rx + ((xx - cx) ** 2) * ry * ry \
                <= (rx * ry) ** 2
        img[mask] = 0.5 * img[mask] + 0.5 * col

    # mild noise
    img += rng.integers(-4, 5, img.shape)
    rgb = np.clip(np.floor(img + 0.5), 0, 255).astype(np.uint8)

    if alpha:
        a = 255.0 * (0.5 + 0.5 * _wave(rng.uniform(1.0, 4.0) * x
                                       + rng.uniform(1.0, 4.0) * y))
        a = np.broadcast_to(a, (height, width)).copy()
        cy, cx = height // 2, width // 2
        a[cy - height // 8:cy + height // 8, cx - width // 8:cx + width // 8] = 255
        a += rng.integers(-3, 4, a.shape)
        a8 = np.clip(np.floor(a + 0.5), 0, 255).astype(np.uint8)
        rgb = np.concatenate([rgb, a8[..., None]], axis=-1)

    rgb = np.ascontiguousarray(rgb)
    return rgb, hashlib.sha256(rgb.tobytes()).hexdigest()


def uastc_winner_buffer(modes: tuple, extra: tuple, n: int, seed: int = 0):
    """A (n, 59) uint8 UASTC search winner buffer [slot | endpoint codes
    (24) | weights (32) | aux | ETC1 intensity] for the slot list (modes,
    extra) of `_effort_mode_set`, in which every slot, and a slot number
    past the list (a row packed as zeros), wins about n / (slots + 1)
    blocks, in random order: endpoint codes each 0, the range's maximum or
    random within the slot's range, weights within its weight bits, the aux
    column a pattern index of its list or a ccs of its channels (random
    where the slot reads none), random ETC1 intensities."""
    from ..codecs.uastc import pack
    from ..codecs.uastc import tables as T

    rng = np.random.default_rng(seed)
    slots = list(modes) + [None] + [pack.EXTRA_MODES[x] for x in extra]
    c = rng.integers(0, 256, (n, 59))
    c[:, 0] = rng.permutation(np.arange(n) % (len(slots) + 1))
    for s, m in enumerate(slots):
        if m is None:
            continue
        mode, wb, ep_range, comps = m
        idx = c[:, 0] == s
        k = int(idx.sum())
        top = len(T.color_unquant_table(ep_range))
        c[idx, 1:25] = np.choose(rng.integers(0, 3, (k, 24)), [
            np.zeros((k, 24), np.int64), np.full((k, 24), top - 1),
            rng.integers(0, top, (k, 24))])
        c[idx, 25:57] = rng.integers(0, 1 << wb, (k, 32))
        n_aux = (len(T.BC7_3_ASTC2_COMMON_PARTITIONS) if mode == 7 else
                 len(T.ASTC_BC7_COMMON_PARTITIONS3)
                 if T.MODE_SUBSETS[mode] == 3 else
                 len(T.ASTC_BC7_COMMON_PARTITIONS2)
                 if T.MODE_SUBSETS[mode] == 2 else
                 comps if T.MODE_PLANES[mode] == 2 else 256)
        c[idx, 57] = np.arange(k) % n_aux
    return c.astype(np.uint8)
