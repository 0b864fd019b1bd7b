"""The hand-written kernels a run launched on the card, read from the device
trace by kernel name and counted under the names of `ops.cuda_etc1s.LAUNCHES`.

`LAUNCHES` counts what the Python wrappers launch when they are called. The
ETC1S frontend's captured CUDA graph (`codecs/etc1s/frontend.py` `_Graph`)
replays its kernels with no wrapper call, so only the device trace sees
those; `traced_launches` counts both alike."""

import re

import torch

from ..ops.cuda_etc1s import LAUNCHES

# the kernel a wrapper launches, as the trace names it (demangled, without
# its return type and anonymous namespace): the scan's shortlist variant by
# its second template argument
_KERNELS = (
    (r"fscan_kernel<\d+, (?:false|\(bool\)0|0)\b", "factorized_scan"),
    (r"fscan_kernel<\d+, (?:true|\(bool\)1|1)\b",
     "factorized_scan_shortlist"),
    ("rescore_kernel", "palette_errs_packed"),
    ("errs_kernel", "palette_errs"),
    ("selbest_wgmma_kernel", "find_best_selector_patterns"),
    ("cross6_argmin_kernel", "cross6_argmin"),
    ("cross6_kernel", "cross6_distances"),
    ("cluster_scan_assemble_kernel", "cluster_scan_assemble"),
    ("bisect_rows_kernel", "bisect_rows"),
    ("bisect_round_kernel", "bisect_round"),
    ("min_k_kernel", "xla_cpu_min_k"),
    ("xla_fma_kernel(?:32|64|_rows)", "xla_fma"),
    ("xla_reduce_kernel(?:32|64)", "xla_reduce"),
    ("line_fit_kernel", "uastc_line_fit"),
    ("mode_trial_kernel", "uastc_mode_trial"),
    ("subset_trial_kernel", "uastc_subset_trial"),
    ("dualplane_trial_kernel", "uastc_dualplane_trial"),
    ("uastc_pack_kernel", "uastc_pack"))
_MATCH = [(re.compile(rf"{p}(?![A-Za-z0-9_])"), k) for p, k in _KERNELS]
_OURS = re.compile("|".join(
    sorted({p.split("<")[0].split("(")[0] for p, _ in _KERNELS})))


def kernel_launch_name(name: str):
    """The `LAUNCHES` name of the wrapper whose kernel the trace calls
    `name`, or None for a kernel of no wrapper (PyTorch's own). Raises for a
    name of one of the port's kernels that no pattern reads."""
    name = re.sub(r"^void ", "", name.replace("(anonymous namespace)::", ""))
    for rx, key in _MATCH:
        if rx.match(name):
            return key
    if _OURS.search(name):
        raise ValueError(f"kernel {name!r}: no wrapper's name reads it")
    return None


def traced_launches(run):
    """run() and a synchronize under torch.profiler, the card's activity
    only: (its result, the launches of each `LAUNCHES` name that the device
    trace saw run, from every thread and graph replay)."""
    from torch.profiler import ProfilerActivity, profile

    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        out = run()
        torch.cuda.synchronize()
    counts = dict.fromkeys(LAUNCHES, 0)
    cuda = torch.autograd.DeviceType.CUDA
    for e in prof.profiler.kineto_results.events():
        if e.device_type() == cuda:
            key = kernel_launch_name(e.name())
            if key is not None:
                counts[key] += 1
    return out, counts
