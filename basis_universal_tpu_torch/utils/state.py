"""Carry the codec's state from the reference into the port.

The ETC1S codec has no trained weights: its state is the codebooks and the
k-means seeds. These helpers turn the reference package's numpy outputs
(endpoint color5/inten5, selector patterns, seed centroids, the random fill
of `bisecting_init`) into the port's tensors on a given device, with the
dtypes the port indexes and packs with: int32 for packed values (colours,
tables, selector values), int64 for block-to-cluster assignments, float32
for vectors.
"""

import numpy as np
import torch


def _to(x, dtype, device):
    return torch.from_numpy(np.array(x, copy=True)).to(device=device,
                                                       dtype=dtype)


def endpoint_codebook(color5, inten5, device="cpu"):
    """(E, 3) 5-bit colours and (E,) intensity tables -> int32 tensors."""
    color5 = np.asarray(color5)
    inten5 = np.asarray(inten5)
    if color5.ndim != 2 or color5.shape[1] != 3 or inten5.shape != color5.shape[:1]:
        raise ValueError(f"bad endpoint codebook shapes {color5.shape}, "
                         f"{inten5.shape}")
    return _to(color5, torch.int32, device), _to(inten5, torch.int32, device)


def selector_patterns(patterns, device="cpu"):
    """(S, 16) selector values 0..3 -> int32 tensor."""
    patterns = np.asarray(patterns)
    if patterns.ndim != 2 or patterns.shape[1] != 16:
        raise ValueError(f"bad selector pattern shape {patterns.shape}")
    return _to(patterns, torch.int32, device)


def assignment(indices, device="cpu"):
    """Block -> cluster indices -> int64 tensor."""
    return _to(np.asarray(indices), torch.int64, device)


def vectors(x, device="cpu"):
    """Centroids, k-means seeds, the random fill of `bisecting_init`, or
    any other float array -> float32 tensor."""
    return _to(np.asarray(x), torch.float32, device)
