"""Kernels: the UASTC trials, `mode_trial_kernel`, `subset_trial_kernel`
and `dualplane_trial_kernel` together, bound times over device times in
the window, in %."""

SPANS = {}


def read(run):
    return run.trace.roofline(["mode_trial_kernel", "subset_trial_kernel",
                               "dualplane_trial_kernel"])
