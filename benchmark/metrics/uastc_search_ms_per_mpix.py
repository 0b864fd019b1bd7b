"""UASTC search and packing (`codecs/uastc/encode.py` `_search_and_pack`,
with `codecs/uastc/pack.py`): its spans' time, ms per Mpix of the
window."""

SPANS = {"search": [
    "basis_universal_tpu_torch.codecs.uastc.encode:_search_and_pack"]}


def read(run):
    t = run.trace
    return (1e3 * t.span_s("search") / t.mpix
            if t.has_spans("search") else None)
