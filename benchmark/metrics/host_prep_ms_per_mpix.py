"""Host prep (`compressor._prepare_slices`, `compressor._prep_uastc_slices`):
its spans' time, ms per Mpix of the window."""

SPANS = {"prep": ["basis_universal_tpu_torch.compressor:_prepare_slices",
                  "basis_universal_tpu_torch.compressor:_prep_uastc_slices"]}


def read(run):
    t = run.trace
    return 1e3 * t.span_s("prep") / t.mpix if t.has_spans("prep") else None
