"""UASTC container (`compressor._assemble_uastc`: `formats/basis_file.py`,
`formats/ktx2.py`): its spans' time, ms per Mpix of the window."""

SPANS = {"uastc_assembly": [
    "basis_universal_tpu_torch.compressor:_assemble_uastc"]}


def read(run):
    t = run.trace
    return (1e3 * t.span_s("uastc_assembly") / t.mpix
            if t.has_spans("uastc_assembly") else None)
