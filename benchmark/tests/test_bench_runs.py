"""Every cell run end to end at a tiny size on the CPU: the result line's
keys, its metrics, and a correct answer."""

import pytest

from benchmark import harness

from .conftest import CELLS, PROOF, SERVED, UNLISTED, run_tiny

SPEC = harness.bench()


def expected(cell, trace):
    ms = SPEC["per_layer"] if trace else SPEC["end_to_end"]
    got = {m["name"] for m in ms if cell in m.get("workloads", [cell]) or cell in UNLISTED}
    if cell in SERVED and trace:
        got |= {"engine.dispatch_ms", "bm25.stage_ms", "fuse.host_ms"}
    if cell in PROOF and trace:
        got |= {"encoder.mfu"}
    if cell in PROOF and "then" not in harness.load("traffic", cell.split(".")[1]):
        got -= {"recall_at_10"}             # ingest: no scan, no recall
    return got


@pytest.mark.parametrize("trace", [False, True], ids=["trace0", "trace1"])
@pytest.mark.parametrize("cell", CELLS + UNLISTED)
def test_result_line(cell, trace):
    line = run_tiny(cell, trace)
    keys = ["correct", "attempted", "failed", "metrics", "device"]
    keys += ["breakdown"] if trace else []
    assert list(line) == keys + ["checks"]      # the compared numbers come last
    assert line["correct"] is True and line["failed"] == 0 and line["attempted"] > 0
    assert set(line["device"]) >= {"platform", "kind", "count", "memory_peak_bytes"}
    for name, c in line["checks"].items():
        assert set(c) == {"value", "limit"} and c["value"] <= c["limit"], name
    # the CPU has no device trace: the device metrics are left out, not 0
    got = set(line["metrics"])
    device_only = {"dense_roofline", "device.idle_share", "bm25.stage_ms", "encoder.mfu"}
    assert got == expected(cell, trace) - device_only
    for m in line["metrics"].values():
        assert m["value"] > 0
    if trace:
        assert set(line["breakdown"]) == {"device_ops", "idle_gaps"}
        assert {"busy_s", "window_s"} <= set(line["device"])


def test_same_seed_same_inputs():
    from benchmark import stores, traffic

    cfg = harness.load("configs", "flat10m_int8")
    cfg.update(rows=3000, dim=16, chunk_rows=1000, centres=8)
    mix = harness.load("traffic", "hybrid_c1")
    a, b = (stores.Store(cfg, 2**31 + 7, __import__("torch").device("cpu")) for _ in range(2))
    assert all((x == y).all() for (_, _, x), (_, _, y) in zip(a.each_chunk(), b.each_chunk()))
    qa, qb = traffic.questions(mix, a, 2**31 + 7), traffic.questions(mix, b, 2**31 + 7)
    assert [q.texts for q in qa] == [q.texts for q in qb]
    assert all((x.rows == y.rows).all() for x, y in zip(qa, qb))
    qc = traffic.questions(mix, a, 5)
    # another seed: the same count of questions a year, in another order
    assert sorted(q.year for q in qc) == sorted(q.year for q in qa)
    assert [q.year for q in qc] != [q.year for q in qa]


def test_batcher_entry():
    """The batcher's front (``entry: batcher``): several clients coalesced."""
    import time

    import torch

    from .conftest import tiny

    cfg, mix, limits = tiny("flat1p5m_bf16.hybrid_c1")
    mix = dict(mix, entry="batcher", clients=4, batcher={"max_batch": 4, "window_ms": 4.0})
    res = harness.run_cell("flat1p5m_bf16.hybrid_c1", cfg, mix, limits, 5, 0.5, False,
                           torch.device("cpu"), time.perf_counter(), lambda *a: None)
    run = res["run"]
    assert run.batcher["requests"] == len(run.window.done) > 0
    assert run.batcher["dispatches"] <= run.batcher["requests"]
    assert all(res["numbers"][n] <= lim for n, lim in limits["limits"].items())


def test_questions_without_a_year_reach_the_whole_store():
    from .conftest import tiny

    import time

    import torch

    cfg, mix, limits = tiny("flat10m_int8.hybrid_c1")
    mix = dict(mix, years=[None, 2022], year_counts=[3, 3])
    res = harness.run_cell("flat10m_int8.hybrid_c1", cfg, mix, limits, 9, 0.5, False,
                           torch.device("cpu"), time.perf_counter(), lambda *a: None)
    assert res["numbers"]["fused_gap"] <= limits["limits"]["fused_gap"]
    assert res["numbers"]["wrong"] == 0 and res["run"].window.done
