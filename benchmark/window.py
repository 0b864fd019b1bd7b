"""The measured window: a closed loop of batch builds.

Calls follow each other back to back, each with the next `per_call`
textures of the pool in turn, and the window closes at the end of the call
that is running when `seconds` have passed. Every texel of every finished
texture counts once; the outputs stay in memory for the check.
"""

import dataclasses
import time
from typing import Callable, List


@dataclasses.dataclass
class Call:
    pool_index: List[int]       # which pool texture each slot holds
    outputs: list               # what the encoder returned for them
    seconds: float = 0.0        # how long the call took


@dataclasses.dataclass
class Window:
    calls: List[Call]
    start: float                # the clock at the first call's start
    seconds: float              # from the first call's start to the last's end
    textures: int               # finished textures
    texels: int
    basis_bytes: int
    missing: int                # textures a call returned no output for

    @property
    def mpix(self) -> float:
        return self.texels / 1e6


def run(encode: Callable, pool: list, per_call: int, seconds: float,
        first: int = 0, clock=time.perf_counter) -> Window:
    """encode(textures) -> one output per texture, each with `basis_data`;
    pool: (H, W, C) arrays, taken in turn from index first."""
    calls, nxt = [], first
    start = last = clock()
    while True:
        idx = [(nxt + i) % len(pool) for i in range(per_call)]
        nxt = (nxt + per_call) % len(pool)
        outs = list(encode([pool[i] for i in idx]))
        now = clock()
        calls.append(Call(idx, outs, now - last))
        last = now
        elapsed = now - start
        if elapsed >= seconds:
            break
    textures = texels = basis_bytes = missing = 0
    for c in calls:
        missing += max(0, len(c.pool_index) - len(c.outputs))
        for i, out in zip(c.pool_index, c.outputs):
            h, w = pool[i].shape[:2]
            textures += 1
            texels += h * w
            basis_bytes += len(out.basis_data)
    return Window(calls, start, elapsed, textures, texels, basis_bytes,
                  missing)
