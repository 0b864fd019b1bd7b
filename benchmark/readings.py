"""The readings a cell's check limits are set from, in one process on the
card: the program's sound runs over many seeds, and each of the
configuration's `controls` (`manifest.control_encoder`) in the program's
place over a few, each a window of one call at the cell's own size and
load, judged on as many textures as a run judges.

    python3 benchmark/readings.py --workload <cell> --seeds 1,2,... \
        --control-seeds 7,8,9 [--controls a,b] [--out readings.jsonl]

Prints one JSON line a seed: every number of the check with the program or
with a control, the sampled files' selector counts and bits per texel, the
seconds of the call and of the check.
"""

import argparse
import json
import pathlib
import sys
import time

START = time.perf_counter()
sys.path[0] = str(pathlib.Path(__file__).resolve().parent.parent)

from benchmark import harness, manifest  # noqa: E402


def reading(cell, seed, encode, device, label):
    import torch

    from benchmark import check, texgen, window

    w = manifest.workload(cell)
    cfg, mix = manifest.config(w["config"]), manifest.traffic(w["traffic"])
    pool = texgen.make_pool(seed, mix, device)
    t = time.perf_counter()
    win = window.run(encode, pool, mix["textures_per_call"], 0.0)
    torch.cuda.synchronize()
    t_call = time.perf_counter() - t
    t = time.perf_counter()
    all_limits = {"bad_files": 0, "unstable_files": 0, "error_ratio": 0.0,
                  "blocks_worse_pct": 0.0, "selector_shortfall_pct": 0.0,
                  "level2_modes_pct": 0.0}
    _, numbers, failed, verdicts = check.run(
        win, pool, cfg, all_limits, seed, mix["check_textures"], device)
    bits = []
    for v in verdicts:
        c, s, p = v["where"]
        h, w = pool[p].shape[:2]
        bits.append(8.0 * len(win.calls[c].outputs[s].basis_data) / (h * w))
    return {"cell": cell, "who": label, "seed": seed,
            "numbers": {n: v for n, v, _ in numbers},
            "codebooks": sorted({v["codebooks"] for v in verdicts
                                 if v["codebooks"]}),
            "bits_per_texel": [min(bits), max(bits)] if bits else None,
            "problems": sorted({v["problem"] for v in verdicts
                                if v["problem"]}),
            "call_s": t_call, "check_s": time.perf_counter() - t}


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seeds", required=True)
    ap.add_argument("--control-seeds", default="")
    ap.add_argument("--controls", default="",
                    help="names of the configuration's controls to run "
                    "(all where empty)")
    ap.add_argument("--out", default="")
    args = ap.parse_args()
    w = manifest.workload(args.workload)
    cfg = manifest.config(w["config"])
    harness.pin_host(cfg)
    import torch

    if not torch.cuda.is_available():
        print("no CUDA card: no readings", file=sys.stderr)
        return 3
    torch.set_num_threads(int(cfg["host"]["torch_threads"]))
    from basis_universal_tpu_torch import compressor

    params = harness._params(cfg, "cuda")
    program = lambda tex: compressor.compress_batch(tex, params)  # noqa
    wanted = set(filter(None, args.controls.split(",")))
    controls = [(c["name"], manifest.control_encoder(c, params))
                for c in cfg["controls"] if not wanted or c["name"] in wanted]
    out = open(args.out, "a") if args.out else None
    print(f"card: {harness.power_limit()}", file=sys.stderr)
    runs = [(int(s), program, "program") for s in args.seeds.split(",")]
    runs += [(int(s), encode, f"control:{name}")
             for name, encode in controls
             for s in args.control_seeds.split(",") if s]
    for seed, encode, label in runs:
        line = json.dumps(reading(args.workload, seed, encode, "cuda", label))
        print(line, flush=True)
        if out:
            out.write(line + "\n")
            out.flush()
    return 0


if __name__ == "__main__":
    sys.exit(main())
