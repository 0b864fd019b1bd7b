"""ETC1S frontend (`codecs/etc1s/frontend.py` `_run_one`: one texture's
device pipeline, dispatched from the host, and its fetch): its spans'
time, ms per Mpix of the window."""

SPANS = {"frontend": [
    "basis_universal_tpu_torch.codecs.etc1s.frontend:_run_one"]}


def read(run):
    t = run.trace
    return (1e3 * t.span_s("frontend") / t.mpix
            if t.has_spans("frontend") else None)
