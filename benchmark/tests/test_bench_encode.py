"""The ``encode`` loop: its id batches, the reference model against the
port's encoder, the work it counts, the planted rows, and what a run
keeps for the readers (brackets, counters, the port's spans)."""

import json
import time
from pathlib import Path

import numpy as np
import pytest
import torch

from benchmark import check, harness, stores, traffic
from benchmark.program_trace import ProgramTrace

from .conftest import PROOF, SEED, TINY_ENCODER, tiny

MODEL = {"reference": "pre_ln_mean_pool",
         "encoder": dict(TINY_ENCODER, max_len=512, moe_experts=0)}
REF = check.model_reference(MODEL)


def ids_of(lengths, L, vocab, seed=3):
    g = torch.Generator().manual_seed(seed)
    ids = torch.randint(0, vocab, (len(lengths), L), generator=g, dtype=torch.int32)
    ids[torch.arange(L)[None] >= torch.tensor(lengths)[:, None]] = -1
    return ids


# --------------------------------------------------------------- traffic

def test_id_batches_are_drawn_from_the_seed():
    mix = harness.load("traffic", "encode127")
    a = traffic.token_batches(mix, SEED, 1 << 15, 512)
    b = traffic.token_batches(mix, SEED, 1 << 15, 512)
    c = traffic.token_batches(mix, SEED + 1, 1 << 15, 512)
    assert len(a) == mix["pool_batches"] and all(x.shape[0] == mix["batch"] for x in a)
    assert all((x == y).all() for x, y in zip(a, b))
    assert not all((x == y).all() for x, y in zip(a, c))
    lens = [np.sort(np.concatenate([(x >= 0).sum(1).numpy() for x in p])) for p in (a, c)]
    assert (lens[0] == lens[1]).all()               # the same lengths, another order
    values = mix["lengths"]["values"]
    assert lens[0].min() == min(values) and lens[0].max() == max(values)
    for x in a:
        n = (x >= 0).sum(1)
        assert x.dtype == torch.int32 and x.shape[1] == traffic.bucket(int(n.max()), 512)
        assert ((x >= 0) == (torch.arange(x.shape[1])[None] < n[:, None])).all()


@pytest.mark.parametrize("longest,width", [(1, 32), (32, 32), (33, 64), (48, 64), (300, 512),
                                           (500, 512)])
def test_bucket_is_the_ports_padding(longest, width):
    """The padded width ``tokenize_batch(bucket_len=True)`` gives a batch
    whose longest text has ``longest`` tokens."""
    from rag_challenge_2_tpu_torch.models.encoder import tokenize_batch

    text = " ".join(["w"] * longest)
    port = tokenize_batch([text], 512, 15, bucket_len=True)
    assert (port >= 0).sum() == longest
    assert traffic.bucket(longest, 512) == width == port.shape[1]


def test_lognormal_lengths_are_clipped_quantiles():
    spec = {"dist": "lognormal", "median": 300, "sigma": 0.35, "lo": 50, "hi": 500}
    n = traffic.text_lengths(spec, 2048)
    assert (np.diff(n) >= 0).all() and n.min() >= spec["lo"] and n.max() == spec["hi"]
    assert abs(np.median(n) - spec["median"]) <= 1


@pytest.mark.parametrize("n", [2048, 1016, 7])
def test_measured_lengths_take_equal_shares(n):
    values = [374, 213, 131, 460, 131]
    got = traffic.text_lengths({"dist": "measured", "values": values}, n)
    assert (np.diff(got) >= 0).all() and set(got.tolist()) <= set(values)
    for v in set(values):                 # each value its share, to one text
        assert abs((got == v).sum() - n * values.count(v) / len(values)) <= 1


def repo_texts(mix_name):
    """The texts a mix's measured lengths were taken from."""
    from rag_challenge_2_tpu_torch.ingestion.splitter import split_text

    data = harness.ROOT / "data" / "test_set"
    if mix_name == "ingest256":
        return [c for f in sorted((data / "pdf_reports").glob("*.txt"))
                for c in split_text(f.read_text(), 300, 50)]
    served = harness.load("traffic", "hybrid_c1")
    company = harness.load("configs", "enc512_flat1p5m_bf16")["company"]
    return ([q["question"] for q in json.loads((data / "questions.json").read_text())]
            + [served["templates"][0].format(year=served["years"][0], company=company,
                                                metric=m) for m in served["metrics"]])


@pytest.mark.parametrize("mix_name", ["encode127", "ingest256"])
def test_measured_lengths_are_the_port_tokens_of_the_repos_texts(mix_name):
    """A mix's ``measured`` lengths are what the port's tokenizer makes of
    the texts its ``of`` names (the deployment's questions; the splitter's
    chunks of the report texts)."""
    from rag_challenge_2_tpu_torch.models.encoder import tokenize_batch

    mix = harness.load("traffic", mix_name)
    enc = harness.load("configs", "enc512_flat1p5m_bf16")["model"]["encoder"]
    ids = tokenize_batch(repo_texts(mix_name), enc["max_len"], enc["vocab_bits"],
                         bucket_len=True)
    assert (ids >= 0).sum(1).tolist() == mix["lengths"]["values"]


# ------------------------------------------------------ reference model

def port_encoder(model, state, monkeypatch):
    """The port's encoder in f32 on the CPU with ``state``, its experts in
    f32 too (they run in bf16 whatever the encoder's type)."""
    from rag_challenge_2_tpu_torch.models import encoder, moe

    monkeypatch.setattr(moe.MoEFFN, "dtype", torch.float32)
    cfg = encoder.EncoderConfig(**model["encoder"], dtype=torch.float32)
    return encoder.EmbeddingModel(cfg, params={k: v.clone() for k, v in state.items()},
                                  device="cpu")


@pytest.mark.parametrize("experts", [0, 4], ids=["dense", "moe"])
@pytest.mark.parametrize("lengths,L", [([5, 32, 17, 1], 32), ([40, 3, 64, 64, 12, 33], 64)])
def test_reference_forward_equals_the_ports_encoder(experts, lengths, L, monkeypatch):
    model = dict(MODEL, encoder=dict(MODEL["encoder"], moe_experts=experts, n_layers=3))
    state = REF.init(model, torch.Generator().manual_seed(11), "cpu")
    ids = ids_of(lengths, L, 1 << model["encoder"]["vocab_bits"])
    got = port_encoder(model, state, monkeypatch).embed_tokens(ids)
    want = REF.forward(state, model, ids)
    assert want.shape == (len(lengths), model["encoder"]["out_dim"])
    assert torch.allclose(want.norm(dim=1), torch.ones(len(lengths)), atol=1e-6)
    # the same f32 sums in another order: measured within 5e-7
    assert (got - want).abs().max() < 1e-5


@pytest.mark.parametrize("experts", [0, 4])
def test_layout_is_the_ports_state_dict(experts):
    from rag_challenge_2_tpu_torch.models.encoder import Encoder, EncoderConfig

    model = dict(MODEL, encoder=dict(MODEL["encoder"], moe_experts=experts))
    port = {k: tuple(v.shape) for k, v in
            Encoder(EncoderConfig(**model["encoder"])).state_dict().items()}
    assert {n: sh for n, sh, _, _ in REF.layout(model)} == port


def test_weights_are_drawn_from_the_generator():
    a = REF.init(MODEL, torch.Generator().manual_seed(5), "cpu")
    b = REF.init(MODEL, torch.Generator().manual_seed(5), "cpu")
    assert all(torch.equal(a[k], b[k]) for k in a)
    assert a["blocks.0.query.weight"].std().item() == pytest.approx(64 ** -0.5, rel=0.05)
    assert a["blocks.1.mlp_out.weight"].std().item() == pytest.approx(128 ** -0.5, rel=0.05)


def test_flops_and_bytes_count_real_tokens():
    ids = ids_of([3, 5], 32, 1024)
    D, F, out = 64, 128, 64
    per_token = 8 * D * D + 4 * D * F
    attn = 4 * D * (3 * 3 + 5 * 5)
    assert REF.flops(MODEL, ids) == 2 * (8 * per_token + attn) + 2 * D * out * 2
    moe = dict(MODEL, encoder=dict(MODEL["encoder"], moe_experts=4))
    assert REF.flops(moe, ids) - REF.flops(MODEL, ids) == 8 * (8 * D * F + 2 * D * 4 - 4 * D * F)
    weights = sum(int(np.prod(sh)) for n, sh, _, _ in REF.layout(MODEL)
                  if n not in ("tok_embed", "pos_embed"))
    rows = torch.unique(ids[ids >= 0]).numel() + 5
    assert REF.bytes(MODEL, ids) == 4 * (ids.numel() + weights + rows * D + 2 * out)


# --------------------------------------------------------------- a run

def test_planted_rows_are_each_texts_nearest():
    cfg, mix, _ = tiny("enc512_flat1p5m_bf16.encode127")
    cfg["planted_noise"] = 0.02      # the tiny model's texts lie at cosine up to 0.97
    su = harness.SetUp(cfg, mix, SEED, torch.device("cpu"))
    n = cfg["planted"]
    rows, vecs = su.store.planted
    assert rows.numel() == n * mix["batch"] * mix["pool_batches"] and (rows.diff() > 0).all()
    chunks = torch.cat([x for _, _, x in su.store.each_chunk()])
    assert torch.equal(chunks[rows], vecs)
    # text j's rows, in the order they were drawn
    own = stores.host_rng(SEED, "planted").choice(su.store.n_rows, rows.numel(), replace=False)
    ref = torch.as_tensor(np.concatenate(su.ref_emb))
    top = (ref @ chunks.T).topk(n, dim=1).indices
    for j in range(ref.shape[0]):
        assert set(top[j].tolist()) == set(own[j * n:(j + 1) * n].tolist())


def run_cell(cell, trace, **mix_keys):
    cfg, mix, limits = tiny(cell)
    mix.update(mix_keys)
    return harness.run_cell(cell, cfg, mix, limits, SEED, 0.5, trace, torch.device("cpu"),
                            time.perf_counter(), lambda *a: None)


@pytest.mark.parametrize("cell", PROOF)
def test_a_traced_encode_run_keeps_what_readers_read(cell):
    res = run_cell(cell, True)
    run = res["run"]
    scans = "then" in harness.load("traffic", cell.split(".")[1])
    assert run.brackets == (("encoder", "dense") if scans else ("encoder",))
    assert run.counters == res["counters"] and "K3" in run.counters
    works = {sp.work.flops for sp in run.spans.named("encoder")}
    assert run.traced.bracket_flops["encoder"] >= max(works) > 0
    assert len(run.spans.named("dense")) == (len(run.window.done) if scans else 0)
    if harness.load("traffic", cell.split(".")[1]).get("program_spans"):
        assert isinstance(run.program_spans, list)
        assert isinstance(run.program_trace, ProgramTrace)
    else:
        assert run.program_spans is None and run.program_trace is None


def test_program_spans_land_on_the_run():
    """With ``program_spans`` the port's own spans of the traced window
    (here the dense entry's) are on ``Run``; without it, none."""
    run = run_cell("enc512_flat1p5m_bf16.encode127", True, program_spans=True)["run"]
    names = {sp.name for sp in run.program_spans}
    assert {"dense.topk", "dense.launch"} <= names
    assert run.program_trace.named("dense.topk")
    scan = run_cell("flat1p5m_bf16.scan127", True)["run"]
    assert scan.program_spans is None and scan.brackets == ("dense",)
    assert scan.counters and not run_cell("flat1p5m_bf16.scan127", False)["run"].brackets


@pytest.mark.parametrize("cell", PROOF)
def test_setup_s_leaves_out_the_reference(cell, monkeypatch):
    """A scanning mix runs the reference in set-up to plant its rows: those
    seconds (here 2 s more) are not in ``setup_s``; without a scan the
    reference runs only after the window."""
    real = harness.SetUp.reference_embeddings

    def slow(self, *a, **kw):
        time.sleep(2.0)
        return real(self, *a, **kw)
    monkeypatch.setattr(harness.SetUp, "reference_embeddings", slow)
    cfg, mix, limits = tiny(cell)
    t_start = time.perf_counter()
    res = harness.run_cell(cell, cfg, mix, limits, SEED, 0.5, False, torch.device("cpu"),
                           t_start, lambda *a: None)
    to_window = res["run"].window.start - t_start
    left_out = to_window - res["run"].setup_s
    if "then" in mix:
        assert 2.0 <= left_out < to_window
    else:
        assert 0 <= left_out < 0.5


def test_an_untraced_run_collects_no_spans():
    run = run_cell("enc512_flat1p5m_bf16.ingest256", False)["run"]
    assert run.program_spans is None and run.traced is None and run.recall is None
    assert run.queries_per_request == 16


def test_the_store_is_made_only_when_the_mix_scans():
    cfg, mix, _ = tiny("enc512_flat1p5m_bf16.ingest256")
    su = harness.SetUp(cfg, mix, SEED, torch.device("cpu"))
    assert su.store.planted is None and not hasattr(su, "emb")
    assert isinstance(su.store, stores.Store)
