"""On the card: a short run of each codec's Kodak-size cell, traced, gives a
correct result with its per-layer metrics, and the device trace holds the
window's kernels. Skipped where there is no CUDA card:

    python -m pytest -m cuda benchmark/tests -q
"""

import time

import pytest

from benchmark import harness, manifest


@pytest.fixture
def card():
    import torch

    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    return torch


@pytest.mark.cuda
@pytest.mark.parametrize("cell", ["etc1s_q128.build_kodak",
                                  "uastc_l2.build_kodak_rgba"])
def test_traced_run_on_the_card(card, cell):
    line, _, _ = harness.measure(cell, 2 ** 31 + 1, 1.0, True,
                                 time.perf_counter())
    assert line["correct"], line["checks"]
    wanted = {m["name"] for m in manifest.metrics_of(cell, "per_layer")}
    assert wanted == set(line["metrics"])
    dev = line["device"]
    assert dev["platform"] == "gpu" and 0 < dev["busy_s"] < dev["window_s"]
    for metric in ("kernels_roofline",):
        assert 0 < line["metrics"][metric]["value"] <= 100
    assert line["breakdown"]["device_ops"]
