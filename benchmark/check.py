"""What decides `correct`: a sample of the window's textures, drawn from the
seed once the window has closed, judged by the plain reference
(`reference/verify.py`), and each number held to its limit.

Numbers (each a limit of the configuration's `check.limits`: a number is
the most it may read, {"at_least": x} the least):
- `bad_files`: textures a call returned no output for, in the whole window,
  and sampled outputs whose files break a rule (containers, CRC-16s,
  format, codebook sizes, the .KTX2 against the .basis); exact, limit 0.
- `unstable_files`: sampled outputs whose texture was encoded again in the
  same place of another call, to other bytes; exact, limit 0.
- `error_ratio`: the largest, over the sample, of a texture's decoded
  squared error over the per-block yardstick's (`reference/blockref.py`).
- `blocks_worse_pct`: the largest, over the sample, of the share of a
  texture's blocks whose decoded error exceeds the yardstick block's.
- `selector_shortfall_pct`: the largest, over the sample, of how far a
  texture's selector codebook falls short of the quality level's size, in
  %: a lower quality level's codebooks are smaller.
- `level2_modes_pct`: the smallest, over the sample, of the share of a
  texture's UASTC blocks in modes that only a level-2 search or above
  picks (at least).
A number the reference could not read (a file that does not decode) is
None, and fails.
"""

import numpy as np

from .reference import verify


def draw_sample(window, n: int, seed: int):
    """(call, slot) of n finished textures, drawn from the seed."""
    done = [(c, s) for c, call in enumerate(window.calls)
            for s in range(len(call.outputs))]
    rng = np.random.default_rng([seed % (1 << 64), 0xC4EC])
    pick = rng.choice(len(done), size=min(n, len(done)), replace=False)
    return [done[i] for i in sorted(pick)]


def _unstable(window, c: int, s: int) -> bool:
    call = window.calls[c]
    out, p = call.outputs[s], call.pool_index[s]
    for other in window.calls:
        if other is call or s >= len(other.outputs) \
                or other.pool_index[s] != p:
            continue
        o = other.outputs[s]
        if (o.basis_data, o.ktx2_data) != (out.basis_data, out.ktx2_data):
            return True
    return False


def holds(value, limit) -> bool:
    """Whether a number keeps its limit: at most a plain limit, at least
    {"at_least": x}; a number not read keeps none."""
    if value is None:
        return False
    if isinstance(limit, dict):
        return value >= limit["at_least"]
    return value <= limit


def describe(limit) -> str:
    return f">= {limit['at_least']}" if isinstance(limit, dict) \
        else f"<= {limit}"


def entry(value, limit) -> dict:
    """A number and its limit as the result line carries them."""
    if isinstance(limit, dict):
        return {"value": value, "limit": limit["at_least"], "at_least": True}
    return {"value": value, "limit": limit}


def run(window, pool, config: dict, limits: dict, seed: int, n: int,
        device="cpu"):
    """(correct, [(name, value, limit)], failed textures, verdicts)."""
    codec = config["codec"]
    q = config["params"].get("quality_level") if codec == "etc1s" else None
    verdicts = []
    for c, s in draw_sample(window, n, seed):
        call = window.calls[c]
        out, tex = call.outputs[s], pool[call.pool_index[s]]
        v = verify.judge(tex, out.basis_data, out.ktx2_data, codec, q,
                         device=device)
        v["unstable"] = _unstable(window, c, s)
        v["where"] = (c, s, call.pool_index[s])
        verdicts.append(v)

    def worst(key, pick=max):
        vals = [v[key] for v in verdicts]
        return None if not vals or None in vals else pick(vals)

    values = {
        "bad_files": window.missing + sum(not v["valid"] for v in verdicts),
        "unstable_files": sum(v["unstable"] for v in verdicts),
        "error_ratio": worst("ratio"),
        "blocks_worse_pct": worst("worse_pct"),
        "selector_shortfall_pct": worst("selector_shortfall_pct"),
        "level2_modes_pct": worst("level2_modes_pct", min),
    }
    numbers = [(name, values[name], limit) for name, limit in limits.items()]
    correct = bool(verdicts) and all(holds(v, lim) for _, v, lim in numbers)
    failed = window.missing + sum(
        (not v["valid"]) or v["unstable"] for v in verdicts)
    return correct, numbers, failed, verdicts
