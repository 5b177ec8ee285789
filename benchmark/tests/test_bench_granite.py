"""The hybrid encoder's configuration in the harness: its reference model
against the port at a small size, the work it counts, and its unlisted
cells found by their files."""

import math

import pytest
import torch

from benchmark import check, harness, roofline

CELL = "granite4h_small_flat1p5m_bf16.query127"
CFG = harness.load("configs", CELL.split(".")[0])
SMALL = dict(CFG["model"]["encoder"], vocab_rows=1000, d_model=64, n_heads=4, mamba_expand=1,
             mamba_head_dim=16, mamba_state=8, mamba_chunk=8, moe_experts=8, moe_top_k=3,
             d_ff=32, experts_held=[2, 6], shared_ff=48, out_dim=32, n_layers=6)
MODEL = {"reference": CFG["model"]["reference"], "encoder": SMALL}
REF = check.model_reference(MODEL)


def ids_of(lengths, L=32):
    g = torch.Generator().manual_seed(3)
    ids = torch.randint(0, SMALL["vocab_rows"], (len(lengths), L), generator=g,
                        dtype=torch.int32)
    ids[torch.arange(L)[None] >= torch.tensor(lengths)[:, None]] = -1
    return ids


def test_reference_is_the_ports_hybrid_in_f32():
    from benchmark import system

    state = REF.init(MODEL, torch.Generator().manual_seed(5), "cpu")
    model = system.embedding_model({"encoder": dict(SMALL, dtype="torch.float32")},
                                   {k: v.clone() for k, v in state.items()},
                                   torch.device("cpu"))
    ids = ids_of([1, 9, 20, 31])
    gap = (model.embed_tokens(ids) - REF.forward(state, MODEL, ids)).norm(dim=1).max()
    assert gap < 1e-5                 # f32 against f32, sums in another order


def test_work_counts_real_tokens_and_the_held_share():
    e = CFG["model"]["encoder"]
    full = {"encoder": e}
    ids = ids_of([26] * 4, 64)
    per_token = REF.flops(full, ids) / (4 * 26)
    assert 2.7e9 < per_token < 2.9e9          # ~1.4 G multiply-adds a token
    short = ids.clone()
    short[:, 13:] = -1
    assert REF.flops(full, short) < 0.51 * REF.flops(full, ids)
    assert REF.token_space(full) == (100352, 512)
    assert roofline.peak_key(REF.compute_type(full)) == "bf16"
    n = sum(math.prod(s) for _, s, _ in REF.layout(full))
    assert 3.2e9 < n < 3.3e9                  # 3.27 B parameters held here


@pytest.mark.parametrize("mix", ["query127", "ingest256"])
def test_proof_is_found_by_its_files(mix):
    cell = harness.unlisted_cell(f"granite4h_small_flat1p5m_bf16.{mix}")
    assert cell["config"] == "granite4h_small_flat1p5m_bf16" and cell["traffic"] == mix
