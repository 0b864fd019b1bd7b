"""ETC1S back end (`compressor._assemble`: `codecs/etc1s/backend.py`,
`native.py`, the writers): its spans' thread time summed over the
assembly pool, ms per Mpix of the window."""

SPANS = {"assembly": ["basis_universal_tpu_torch.compressor:_assemble"]}


def read(run):
    t = run.trace
    return (1e3 * t.span_s("assembly") / t.mpix
            if t.has_spans("assembly") else None)
