"""Shared pieces of the benchmark's CPU tests: each cell of
``BENCHMARK.json`` cut to a size a test run holds (the harness's look for
a card skipped: the port runs its plain versions on the CPU)."""

import time

import pytest
import torch

from benchmark import harness

CELLS = [w["name"] for w in harness.bench()["workloads"]]
# the served hybrid: measured, held to the reference, not a cell yet
SERVED = ["flat10m_int8.hybrid_c1", "flat1p5m_bf16.hybrid_c1"]
SEED = 2**31 + 12345


def tiny(cell: str):
    """``(cfg, mix, limits)`` of ``cell`` at a CPU test's size."""
    config, traffic = cell.split(".")
    cfg = harness.load("configs", config)
    cfg.update(rows=24000, dim=64, chunk_rows=5000)
    if cfg["centres"]:
        cfg["centres"] = 64
    cfg["csr"] = dict(cfg["csr"], vocab_bits=12, max_postings=32, slack=1152)
    mix = harness.load("traffic", traffic)
    if mix["loop"] == "scan":
        mix.update(batch=16, pool_batches=3)
    else:
        mix.update(year_counts=[3, 3, 3, 3], queries_per_request=4, trace_seconds=0.5)
        mix["search"] = dict(mix["search"], max_queries=4)
    return cfg, mix, harness.load("limits", cell)


def run_tiny(cell: str, trace: bool = False, seconds: float = 0.5, seed: int = SEED):
    """One run of ``cell`` at its tiny size on the CPU: its result line."""
    cfg, mix, limits = tiny(cell)
    spec = harness.bench()
    res = harness.run_cell(cell, cfg, mix, limits, seed, seconds, trace,
                           torch.device("cpu"), time.perf_counter(), lambda *a: None)
    metrics = spec["per_layer"] if trace else spec["end_to_end"]
    if cell in SERVED:              # as run.py takes a cell not listed yet
        extra = harness.unlisted_cell(cell)["per_layer"] if trace else []
        metrics = [dict(m, workloads=[cell]) for m in metrics + extra]
    return harness.result_line(res, metrics, trace, limits, torch.device("cpu"))


@pytest.fixture
def card():
    """The CUDA card, or a skip: decided when a test asks, never at import."""
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA CUDA card")
    return torch.device("cuda", 0)
