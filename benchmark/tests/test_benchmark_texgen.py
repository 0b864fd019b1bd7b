"""The PyTorch copy of the port's synthetic textures: one seed, one set of
bytes; another seed, others."""

import numpy as np
import pytest
import torch

from benchmark import texgen

BIG = 2 ** 31 + 12345


def test_same_seed_same_bytes_other_seed_other_bytes():
    a = texgen.synthetic_texture(48, 64, texgen.texture_seed(BIG, 0), False,
                                 "cpu")
    b = texgen.synthetic_texture(48, 64, texgen.texture_seed(BIG, 0), False,
                                 "cpu")
    c = texgen.synthetic_texture(48, 64, texgen.texture_seed(BIG + 1, 0),
                                 False, "cpu")
    d = texgen.synthetic_texture(48, 64, texgen.texture_seed(BIG, 1), False,
                                 "cpu")
    assert a.shape == (48, 64, 3) and a.dtype == torch.uint8
    assert torch.equal(a, b)
    assert not torch.equal(a, c) and not torch.equal(a, d)


def test_alpha_texture_and_its_share():
    t = texgen.synthetic_texture(64, 64, 7, True, "cpu")
    assert t.shape == (64, 64, 4)
    assert (t[..., 3] != 255).any() and (t[24:40, 24:40, 3] >= 252).all()
    kinds = [texgen.has_alpha(i, 0.25) for i in range(128)]
    assert sum(kinds) == 32 and kinds[:8] == [False] * 3 + [True] \
        + [False] * 3 + [True]
    assert not any(texgen.has_alpha(i, 0.0) for i in range(64))
    assert all(texgen.has_alpha(i, 1.0) for i in range(64))


@pytest.mark.parametrize("seed", [0, 1, 2 ** 33 + 5, -3])
def test_pool_is_distinct_and_drawn_from_the_seed(seed):
    mix = dict(width=32, height=16, pool=6, alpha_share=0.5)
    pool = texgen.make_pool(seed, mix, "cpu")
    again = texgen.make_pool(seed, mix, "cpu")
    assert len(pool) == 6
    assert all(np.array_equal(x, y) for x, y in zip(pool, again))
    assert len({p.tobytes() for p in pool}) == 6
    assert [p.shape[-1] for p in pool] == [3, 4] * 3


def test_content_is_structured_like_the_ports():
    """Gradients, waves, shapes and mild noise: neither flat nor noise."""
    t = texgen.synthetic_texture(256, 256, 3, False, "cpu").float()
    step = (t[:, 1:] - t[:, :-1]).abs().mean()
    assert 1.0 < float(step) < 20.0
    assert float(t.std()) > 20.0
