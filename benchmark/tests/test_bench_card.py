"""The harness on the card at a tiny size: the kernels' answers pass the
check, the trace ties device time to the dense brackets (and counts the
encoder's operations), and the control fails.  Run on the card with
``python -m pytest benchmark/tests -m cuda``."""

import time

import pytest

from benchmark import control, harness

from .conftest import CELLS, PROOF, SEED, SERVED, tiny


@pytest.mark.cuda
@pytest.mark.parametrize("cell", CELLS + SERVED)
def test_cell_on_the_card(cell, card):
    cfg, mix, limits = tiny(cell)
    spec = harness.bench()
    res = harness.run_cell(cell, cfg, mix, limits, SEED, 1.0, True, card,
                           time.perf_counter(), lambda *a: None)
    metrics = [dict(m, workloads=[cell]) for m in spec["per_layer"]]
    line = harness.result_line(res, metrics, True, limits, card)
    assert line["correct"] is True, line["checks"]
    assert line["device"]["platform"] == "gpu" and line["device"]["busy_s"] > 0
    assert 0 < line["metrics"]["dense_roofline"]["value"] <= 105
    got, bad = control.readings(cell, SEED, card, cfg, mix, limits)
    assert any(bad[n] > lim for n, lim in limits["limits"].items()), bad


@pytest.mark.cuda
@pytest.mark.parametrize("cell", PROOF)
def test_proof_cell_on_the_card(cell, card):
    cfg, mix, limits = tiny(cell)
    res = harness.run_cell(cell, cfg, mix, limits, SEED, 1.0, True, card,
                           time.perf_counter(), lambda *a: None)
    metrics = [dict(m, workloads=[cell]) for m in harness.bench()["per_layer"]]
    metrics += harness.unlisted_cell(cell)["per_layer"]
    line = harness.result_line(res, metrics, True, limits, card)
    assert line["correct"] is True, line["checks"]
    assert 0 < line["metrics"]["encoder.mfu"]["value"] <= 105
    if "then" in mix:
        assert 0 < line["metrics"]["dense_roofline"]["value"] <= 105
    got, bad = control.readings(cell, SEED, card, cfg, mix, limits)
    assert bad["embed_gap"] > limits["limits"]["embed_gap"] >= got["embed_gap"], (got, bad)
