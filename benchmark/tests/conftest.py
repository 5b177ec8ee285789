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
# the model's proof cells: its encoder, with and without the scan; not cells yet
PROOF = ["enc512_flat1p5m_bf16.encode127", "enc512_flat1p5m_bf16.ingest256"]
UNLISTED = SERVED + PROOF
# the model's widths at a test's size (its store's dim is the projection's)
TINY_ENCODER = dict(vocab_bits=10, d_model=64, n_layers=2, n_heads=4, d_ff=128, out_dim=64)
SEED = 2**31 + 12345


def tiny(cell: str):
    """``(cfg, mix, limits)`` of ``cell`` at a CPU test's size."""
    config, traffic = cell.split(".")
    cfg = harness.load("configs", config)
    cfg.update(rows=24000, dim=64, chunk_rows=5000)
    if cfg["centres"]:
        cfg["centres"] = 64
    cfg["csr"] = dict(cfg["csr"], vocab_bits=12, max_postings=32, slack=1152)
    if "model" in cfg:
        cfg["model"] = dict(cfg["model"], encoder=dict(cfg["model"]["encoder"], **TINY_ENCODER))
    mix = harness.load("traffic", traffic)
    if mix["loop"] in ("scan", "encode"):
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
    if cell in UNLISTED:            # as run.py takes a cell not listed yet
        extra = harness.unlisted_cell(cell)["per_layer"] if trace else []
        metrics = [dict(m, workloads=[cell]) for m in metrics + extra]
    return harness.result_line(res, metrics, trace, limits, torch.device("cpu"))


@pytest.fixture
def card():
    """The CUDA card, or a skip: decided when a test asks, never at import."""
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA CUDA card")
    return torch.device("cuda", 0)
