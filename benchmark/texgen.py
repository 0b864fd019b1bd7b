"""The textures a run encodes, made on the device from the run's seed.

A PyTorch copy of the port's `testing/synthetic.synthetic_texture`: smooth
gradients, periodic waves, hard-edged flat shapes and mild noise, and with
alpha a wave, an opaque square and noise. Its few shape parameters come from
NumPy's generator in the original's order; the per-texel noise, the one
large draw, comes from a `torch.Generator` on the device, so a 2048x2048
texture takes milliseconds instead of seconds. The same seed gives the same
bytes on the same kind of device.
"""

import numpy as np
import torch


def _wave(phase):
    p = phase - torch.floor(phase)
    tri = 4.0 * torch.abs(p - 0.5) - 1.0
    return tri * (1.5 - 0.5 * tri * tri)


def texture_seed(seed: int, index: int) -> int:
    """The 63-bit seed of a run's index-th texture."""
    state = np.random.SeedSequence([seed % (1 << 64), index]).generate_state(
        2, np.uint32)
    return (int(state[0]) << 31) ^ int(state[1])


def synthetic_texture(height: int, width: int, seed: int, alpha: bool,
                      device) -> torch.Tensor:
    """(H, W, 3 | 4) uint8 on device."""
    rng = np.random.default_rng(seed)
    gen = torch.Generator(device=device)
    gen.manual_seed(seed & ((1 << 63) - 1))
    f = dict(dtype=torch.float32, device=device)
    y = (torch.arange(height, **f) / max(height - 1, 1))[:, None]
    x = (torch.arange(width, **f) / max(width - 1, 1))[None, :]
    img = torch.zeros((height, width, 3), **f)

    for _ in range(3):
        a, b = map(float, rng.uniform(-1.0, 1.0, 2))
        col = torch.as_tensor(rng.uniform(-90.0, 90.0, 3), **f)
        img += (a * x + b * y)[..., None] * col
    img += torch.as_tensor(rng.uniform(60.0, 190.0, 3), **f)

    for _ in range(4):
        fx, fy = map(float, rng.uniform(-12.0, 12.0, 2))
        ph = float(rng.uniform(0.0, 1.0))
        amp = torch.as_tensor(rng.uniform(5.0, 30.0, 3), **f)
        img += _wave(fx * x + fy * y + ph)[..., None] * amp

    yy = torch.arange(height, device=device)[:, None]
    xx = torch.arange(width, device=device)[None, :]
    for _ in range(int(rng.integers(6, 12))):
        col = torch.as_tensor(rng.uniform(0.0, 255.0, 3), **f)
        cy = int(rng.integers(0, height))
        cx = int(rng.integers(0, width))
        ry = int(rng.integers(2, max(3, height // 5)))
        rx = int(rng.integers(2, max(3, width // 5)))
        if rng.integers(0, 2):
            mask = ((yy - cy).abs() <= ry) & ((xx - cx).abs() <= rx)
        else:
            mask = ((yy - cy) ** 2) * rx * rx + ((xx - cx) ** 2) * ry * ry \
                <= (rx * ry) ** 2
        img = torch.where(mask[..., None], 0.5 * img + 0.5 * col, img)

    img += torch.randint(-4, 5, img.shape, generator=gen,
                         device=device).float()
    rgb = torch.clamp(torch.floor(img + 0.5), 0, 255).to(torch.uint8)
    if not alpha:
        return rgb
    ax, ay = float(rng.uniform(1.0, 4.0)), float(rng.uniform(1.0, 4.0))
    a = 255.0 * (0.5 + 0.5 * _wave(ax * x + ay * y))
    a = a.expand(height, width).clone()
    cy, cx = height // 2, width // 2
    a[cy - height // 8:cy + height // 8, cx - width // 8:cx + width // 8] = 255
    a += torch.randint(-3, 4, a.shape, generator=gen, device=device).float()
    a8 = torch.clamp(torch.floor(a + 0.5), 0, 255).to(torch.uint8)
    return torch.cat([rgb, a8[..., None]], -1)


def has_alpha(index: int, share: float) -> bool:
    """Whether a pool's index-th texture carries alpha: share of them, spread
    evenly, the same ones for every seed."""
    return int((index + 1) * share) > int(index * share)


def make_pool(seed: int, traffic: dict, device) -> list:
    """The run's distinct textures as host (H, W, 3 | 4) uint8 arrays."""
    pool = []
    for i in range(traffic["pool"]):
        t = synthetic_texture(traffic["height"], traffic["width"],
                              texture_seed(seed, i),
                              has_alpha(i, traffic.get("alpha_share", 0.0)),
                              device)
        pool.append(t.cpu().numpy())
    return pool
