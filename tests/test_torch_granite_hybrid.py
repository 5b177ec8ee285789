"""The Mamba-2 / attention hybrid backbone (``models/hybrid.py``) and its
dropless expert layer (``models/moe.DroplessMoE``) against the plain f32
reference (``tests/reference_models/granite_moe_hybrid.py``, the
benchmark's copy) at a small size, on seeded random weights; the preset
encoder left as it was; the benchmark configuration's keys against the
published ones it states."""

import hashlib
import json
from pathlib import Path

import numpy as np
import pytest
import torch

from rag_challenge_2_tpu_torch.models import hybrid
from rag_challenge_2_tpu_torch.models.encoder import (
    EmbeddingModel, Encoder, EncoderConfig, tokenize_batch)
from rag_challenge_2_tpu_torch.models.moe import DroplessMoE
from rag_challenge_2_tpu_torch.utils import profiling as pf
from tests.reference_models import granite_moe_hybrid as ref

ROOT = Path(__file__).resolve().parent.parent
# small widths of every kind: a Mamba-2 layer's heads, state, conv and a
# chunk of 8; an attention layer with two query heads a key/value head;
# 8 routed experts, top 3, and a shared expert; a vocabulary of 1000 rows
ENC = dict(arch="hybrid", vocab_rows=1000, d_model=64, n_layers=3,
           layer_types=["mamba", "mamba", "attention"], n_heads=4, gqa_group=2,
           attention_multiplier=0.05, mamba_expand=1, mamba_head_dim=16, mamba_state=8,
           mamba_conv=4, mamba_chunk=8, moe_experts=8, moe_top_k=3, d_ff=32,
           experts_held=[0, 8], shared_ff=48, norm_eps=1e-5, embedding_multiplier=12,
           residual_multiplier=0.22, max_len=64, out_dim=32)
LENGTHS = [1, 8, 27, 13, 5]      # one token, one chunk, three chunks and a ragged tail
# f32 against f32 with the sums in another order (the scan chunked, the
# experts grouped): a few float32 ulps of the outputs' scale
ATOL = 2e-6


def model_of(**over):
    return {"encoder": dict(ENC, **over)}


def sizes(**over):
    return ref._sizes(model_of(**over))


@pytest.fixture(scope="module")
def weights():
    return ref.init(model_of(), torch.Generator().manual_seed(1), "cpu")


def port(weights, **over):
    cfg = EncoderConfig(**dict(ENC, **over), dtype=torch.float32)
    return EmbeddingModel(cfg, params=weights, device="cpu")


def batch(lengths, L=32, seed=2):
    g = torch.Generator().manual_seed(seed)
    ids = torch.randint(0, ENC["vocab_rows"], (len(lengths), L), generator=g, dtype=torch.int32)
    ids[torch.arange(L)[None] >= torch.tensor(lengths)[:, None]] = -1
    return ids


def mm(a, b):
    return a @ b


def scaled(a, b):
    """The largest gap between ``a`` and ``b`` over ``b``'s largest value."""
    return float((a - b).abs().max() / b.abs().max())


@pytest.mark.parametrize("L", [1, 8, 27])
def test_chunked_scan_matches_the_sequential_recurrence(weights, L):
    """The mixer with its chunked scan against the reference's one step a
    position, across chunk boundaries and a ragged last chunk."""
    m = port(weights).module.layers[0].mamba
    h = torch.randn(3, L, 64, generator=torch.Generator().manual_seed(L))
    with torch.no_grad():
        got = m(h)
    want = ref._mamba(h, weights, "layers.0.mamba", sizes(), mm, lambda t: t)
    assert scaled(got, want) < 1e-5


def test_the_carried_state_reaches_the_next_chunk(weights):
    """What the chunks carry is read: the scan cut at every chunk is not
    the recurrence past the first chunk."""
    x = torch.randn(2, 27, 4, 16, generator=torch.Generator().manual_seed(3))
    dt = torch.full((2, 27, 4), 0.02)
    A = -torch.tensor([1.0, 2.0, 4.0, 8.0])
    B, C = (torch.rand(2, 27, 8, generator=torch.Generator().manual_seed(s)) for s in (4, 5))
    whole = hybrid.ssd(x, dt, A, B, C, 8)
    cut = torch.cat([hybrid.ssd(x[:, c:c + 8], dt[:, c:c + 8], A, B[:, c:c + 8],
                                C[:, c:c + 8], 8) for c in range(0, 27, 8)], 1)
    assert torch.allclose(whole[:, :8], cut[:, :8], atol=1e-6)
    assert (whole[:, 8:] - cut[:, 8:]).abs().max() > 0.1 * whole.abs().max()


def test_causal_nope_gqa_attention(weights):
    m = port(weights).module.layers[2].attn
    h = torch.randn(3, 11, 64, generator=torch.Generator().manual_seed(6))
    with torch.no_grad():
        got = m(h)
    want = ref._attention(h, weights, "layers.2.attn", sizes(), mm)
    assert scaled(got, want) < 1e-5
    with torch.no_grad():              # causal: a later position changes nothing before it
        h2 = h.clone()
        h2[:, 7:] += 1.0
        assert torch.allclose(m(h2)[:, :7], got[:, :7], atol=1e-6)


def test_dropless_moe_with_its_shared_expert(weights):
    moe = port(weights).module.layers[1].moe
    h = torch.randn(40, 64, generator=torch.Generator().manual_seed(7))
    with torch.no_grad():
        got = moe(h)
    want = ref._experts(h, weights, "layers.1.moe", sizes(), mm)
    assert scaled(got, want) < 1e-5


def test_held_shares_sum_to_the_whole_layer(weights):
    """Expert parallelism's share test: the parts two devices holding
    experts 0-3 and 4-7 compute, with the shared expert that both compute
    counted once, add up to the uncut reference's whole layer."""
    h = torch.randn(50, 64, generator=torch.Generator().manual_seed(8))
    p = "layers.1.moe"
    parts = []
    for lo, hi in ((0, 4), (4, 8)):
        moe = DroplessMoE(64, 32, 8, 3, (lo, hi), 48, torch.float32)
        moe.load_state_dict({"router": weights[f"{p}.router"],
                             "w_in": weights[f"{p}.w_in"][lo:hi],
                             "w_out": weights[f"{p}.w_out"][lo:hi],
                             "shared_in": weights[f"{p}.shared_in"],
                             "shared_out": weights[f"{p}.shared_out"]})
        with torch.no_grad():
            parts.append(moe(h))
    shared = ref._glu(h, weights[f"{p}.shared_in"], weights[f"{p}.shared_out"], mm)
    whole = ref._experts(h, weights, p, sizes(), mm)
    assert scaled(parts[0] + parts[1] - shared, whole) < 1e-5
    assert scaled(parts[0], whole) > 0.05 and scaled(parts[1], whole) > 0.05


def test_backbone_through_embed_tokens_matches_the_reference(weights):
    ids = batch(LENGTHS)
    got = port(weights).embed_tokens(ids)
    want = ref.forward(weights, model_of(), ids)
    assert got.shape == (5, 32) and got.dtype == torch.float32
    assert (got - want).norm(dim=1).max() < ATOL * 10
    assert torch.allclose(got.norm(dim=1), torch.ones(5), atol=1e-6)


def test_held_experts_reference_matches_the_cut_program(weights):
    """A device holding experts 2-6 only: program and reference both leave
    out the others' part."""
    p = "layers.{}.moe"
    cut = dict(weights)
    for i in range(3):
        for w in ("w_in", "w_out"):
            cut[f"{p.format(i)}.{w}"] = weights[f"{p.format(i)}.{w}"][2:6]
    ids = batch(LENGTHS)
    got = port(cut, experts_held=[2, 6]).embed_tokens(ids)
    want = ref.forward(cut, model_of(experts_held=[2, 6]), ids)
    assert (got - want).norm(dim=1).max() < ATOL * 10
    assert (got - port(weights).embed_tokens(ids)).norm(dim=1).min() > 1e-4


def test_a_text_alone_and_in_a_padded_batch(weights):
    """Right padding and the batch's other texts change nothing of a real
    token's result (causal mixers, an expert layer that drops nothing)."""
    m = port(weights)
    ids = batch(LENGTHS)
    together = m.embed_tokens(ids)
    for i, n in enumerate(LENGTHS):
        alone = m.embed_tokens(ids[i:i + 1, :n])
        # another batch shape: the products' sums may round otherwise
        assert (alone[0] - together[i]).norm() < 1e-6


def test_bf16_program_stays_near_the_f32_reference(weights):
    m = EmbeddingModel(EncoderConfig(**ENC, dtype=torch.bfloat16), params=weights, device="cpu")
    assert m.module.layers[0].mamba.in_proj.dtype == torch.bfloat16
    assert m.module.layers[0].mamba.A_log.dtype == torch.float32
    assert m.module.layers[0].moe.router.dtype == torch.float32
    ids = batch(LENGTHS)
    gap = (m.embed_tokens(ids) - ref.forward(weights, model_of(), ids)).norm(dim=1).max()
    assert 1e-5 < gap < 0.02             # bf16 products: about 2^-8 relative


def test_spans_of_a_forward(weights):
    m = port(weights)
    ids = batch(LENGTHS)
    with pf.collect() as spans:
        m.embed_tokens(ids)
    names = [s.name for s in spans]
    by_id = {s.id: s for s in spans}
    assert names.count("encoder.forward") == 1
    assert names.count("encoder.mamba") == names.count("encoder.mamba.scan") == 2
    assert names.count("encoder.attention") == 1
    for n in ("encoder.moe.route", "encoder.moe.experts", "encoder.moe.shared"):
        assert names.count(n) == 3
    fwd = next(s for s in spans if s.name == "encoder.forward")
    assert fwd.attrs == {"positions": 5 * 32, "tokens": sum(LENGTHS)}
    for s in spans:
        if s.name == "encoder.mamba.scan":
            assert by_id[s.parent].name == "encoder.mamba"
        if s.name == "encoder.moe.experts":
            assert len(s.attrs["rows"]) == 8 and sum(s.attrs["rows"]) == s.attrs["routed"]
            assert s.attrs["routed"] == 3 * sum(LENGTHS)           # every real token, top 3


def test_preset_still_builds_the_pre_ln_encoder_bitwise():
    """``EncoderConfig()`` and its MoE form build ``Encoder`` with the very
    weights they drew before the module was built on its device (hashes of
    the parent's draw)."""
    want = {EncoderConfig(): "03a391dcbe505954844bd5d45e6effabf39a3816bd002307cc3c22e55bb10bcf",
            EncoderConfig(vocab_bits=10, d_model=64, n_layers=2, n_heads=4, d_ff=128,
                          moe_experts=4):
                "5ea698456bf816e1a8c04c326e558fb7b0633ab2bce1917912ff77b8af695cc2"}
    for cfg, digest in want.items():
        m = EmbeddingModel(cfg, device="cpu")
        assert type(m.module) is Encoder and cfg.arch == "pre_ln"
        h = hashlib.sha256()
        for k, v in m.module.state_dict().items():
            h.update(k.encode())
            h.update(v.contiguous().numpy().tobytes())
        assert h.hexdigest() == digest


def test_tokens_fold_into_a_vocabulary_that_is_not_a_power_of_two():
    texts = ["营业收入 2023 年 revenue", "金盘科技 净利润"]
    ids = tokenize_batch(texts, 16, 15, vocab_rows=100352)
    wide = tokenize_batch(texts, 16, 31)
    assert ((ids >= 0) == (wide >= 0)).all() and ids.max() < 100352
    assert (ids[ids >= 0] == wide[wide >= 0] % 100352).all()
    assert ids.dtype == np.int32


def test_embed_runs_texts_through_the_hybrid(weights):
    m = port(weights, vocab_rows=1000)
    texts = ["营业收入 2023", "金盘科技 净利润 revenue growth"]
    e = m.embed(texts)
    ids = torch.from_numpy(tokenize_batch(texts, 64, 15, bucket_len=True, vocab_rows=1000))
    assert np.allclose(e, ref.forward(weights, model_of(), ids).numpy(), atol=ATOL * 10)


def test_the_hybrid_takes_its_weights_from_params():
    with pytest.raises(ValueError, match="params"):
        EmbeddingModel(EncoderConfig(**ENC), device="cpu")


def test_the_two_reference_copies_are_one_file():
    bench = ROOT / "benchmark" / "reference" / "models" / "granite_moe_hybrid.py"
    assert bench.read_bytes() == (ROOT / "tests" / "reference_models" /
                                  "granite_moe_hybrid.py").read_bytes()


def test_the_configuration_states_the_published_keys_it_runs():
    """The benchmark configuration's ``model.encoder`` (what the port runs)
    agrees with its top-level keys (the published config.json, cut)."""
    cfg = json.loads((ROOT / "benchmark" / "configs" /
                      "granite4h_small_flat1p5m_bf16.json").read_text())
    e = cfg["model"]["encoder"]
    types = [e["layer_types"][i % len(e["layer_types"])] for i in range(e["n_layers"])]
    held = e["experts_held"][1] - e["experts_held"][0]
    assert cfg["model_type"] == "granitemoehybrid" and e["arch"] == "hybrid"
    assert (cfg["hidden_size"], cfg["num_hidden_layers"], cfg["layer_types"]) == (
        e["d_model"], e["n_layers"], types)
    assert cfg["num_attention_heads"] == e["n_heads"]
    assert cfg["num_attention_heads"] // cfg["num_key_value_heads"] == e["gqa_group"]
    assert cfg["position_embedding_type"] == "nope" and not cfg["attention_bias"]
    assert cfg["attention_multiplier"] == e["attention_multiplier"]
    assert (cfg["mamba_expand"], cfg["mamba_d_head"], cfg["mamba_d_state"],
            cfg["mamba_d_conv"], cfg["mamba_chunk_size"]) == (
        e["mamba_expand"], e["mamba_head_dim"], e["mamba_state"], e["mamba_conv"],
        e["mamba_chunk"])
    assert cfg["mamba_n_heads"] * cfg["mamba_d_head"] == e["mamba_expand"] * e["d_model"]
    assert cfg["mamba_n_groups"] == 1 and cfg["mamba_conv_bias"] and not cfg["mamba_proj_bias"]
    assert (cfg["num_experts_per_tok"], cfg["intermediate_size"],
            cfg["shared_intermediate_size"], cfg["num_local_experts"]) == (
        e["moe_top_k"], e["d_ff"], e["shared_ff"], held)
    assert e["moe_experts"] == 72 and cfg["hidden_act"] == "silu"
    assert (cfg["rms_norm_eps"], cfg["embedding_multiplier"], cfg["residual_multiplier"],
            cfg["vocab_size"]) == (e["norm_eps"], e["embedding_multiplier"],
                                   e["residual_multiplier"], e["vocab_rows"])
    assert cfg["reduced"] == ["num_hidden_layers", "layer_types", "num_local_experts"]
    EncoderConfig(**{k: v for k, v in e.items() if k != "dtype"})     # every key taken
