"""The window's accounting against a stub encoder: whole calls, every texel
of every finished texture counted once, textures without an output
counted as missing."""

import types

import numpy as np

from benchmark import window


class Clock:
    """Advances by a step on every read."""

    def __init__(self, step):
        self.t, self.step = 0.0, step

    def __call__(self):
        self.t += self.step
        return self.t


def stub(drop=0):
    def encode(textures):
        return [types.SimpleNamespace(basis_data=b"x" * (t.shape[0] + 1))
                for t in textures[:len(textures) - drop]]
    return encode


def pool():
    return [np.zeros((8 + 4 * i, 12, 3), np.uint8) for i in range(6)]


def test_whole_calls_and_texels_counted_once():
    p = pool()
    w = window.run(stub(), p, 4, seconds=10.0, clock=Clock(1.0))
    # the clock reads 1 at the start and 1 + k after the k-th call
    assert len(w.calls) == 10 and w.seconds == 10.0
    assert [c.pool_index for c in w.calls[:3]] == [[0, 1, 2, 3],
                                                   [4, 5, 0, 1],
                                                   [2, 3, 4, 5]]
    want = sum(p[i].shape[0] * 12 for c in w.calls for i in c.pool_index)
    assert w.texels == want and w.textures == 40 and w.missing == 0
    assert w.basis_bytes == sum(p[i].shape[0] + 1 for c in w.calls
                                for i in c.pool_index)
    assert w.mpix == want / 1e6


def test_the_call_running_at_the_end_finishes():
    w = window.run(stub(), pool(), 3, seconds=2.5, clock=Clock(1.0))
    assert len(w.calls) == 3 and w.seconds == 3.0


def test_zero_seconds_is_one_call():
    w = window.run(stub(), pool(), 2, seconds=0.0, clock=Clock(1.0))
    assert len(w.calls) == 1


def test_missing_outputs_are_counted_and_not_their_texels():
    p = pool()
    w = window.run(stub(drop=2), p, 4, seconds=3.0, clock=Clock(1.0))
    assert w.missing == 2 * len(w.calls)
    assert w.textures == 2 * len(w.calls)
    assert w.texels == sum(p[i].shape[0] * 12 for c in w.calls
                           for i in c.pool_index[:2])
