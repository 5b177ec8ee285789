"""The port's pipeline (``pipeline/``) and its command line held against the
JAX package's, on the CPU.

``RunConfig`` and the presets registry equal field by field; the data-set
paths equal.  Each stage run on a copy of the repo's test set by both
packages, with one numpy embedder and each package's extractive stub in the
LLM's seat, gives equal artifacts: parsed, merged and chunked reports byte
for byte, the index npz bitwise (CSR and embedding rows), and the answers
files equal once the wall-clock timings are taken out.  The presets run are
``offline`` with BM25 (the served hybrid path) and the ``scale10m`` flags
(int8 store, IVF probes over the cluster-ordered store).  Without saved
encoder params the pipeline pretrains an encoder on the corpus, as the
JAX package does, and saves it in the JAX package's layout."""

import dataclasses
import json
import shutil

import pytest

import rag_challenge_2_tpu.ingestion.splitter as jax_splitter
import rag_challenge_2_tpu.pipeline as JP
import rag_challenge_2_tpu_torch.ingestion.splitter as port_splitter
import rag_challenge_2_tpu_torch.pipeline as TP
from rag_challenge_2_tpu.eval.e2e import ExtractiveStubProvider as JaxExtractive
from rag_challenge_2_tpu_torch import cli
from rag_challenge_2_tpu_torch.eval.e2e import ExtractiveStubProvider
from tests.test_torch_ingestion import assert_same_dirs, assert_same_npz, hashed_embedder

PRESETS = {
    "offline_bm25": dict(base="offline", use_bm25_db=True),
    "scale10m_flags": dict(base="offline", use_bm25_db=True, quantize_int8=True,
                           use_ivf=True, ivf_nprobe=8, cluster_order=True, scan_rt=0.95),
}


@pytest.fixture(autouse=True)
def heuristic_tokens(monkeypatch):
    for mod in (jax_splitter, port_splitter):
        monkeypatch.setattr(mod, "_encoding", lambda: None)


def test_run_config_fields_match_jax():
    got = [(f.name, f.default) for f in dataclasses.fields(TP.RunConfig)]
    assert got == [(f.name, f.default) for f in dataclasses.fields(JP.RunConfig)]


@pytest.mark.parametrize("name", sorted(JP.configs))
def test_presets_match_jax(name):
    assert sorted(TP.configs) == sorted(JP.configs)
    assert dataclasses.asdict(TP.configs[name]) == dataclasses.asdict(JP.configs[name])


@pytest.mark.parametrize("serialized,suffix", [(False, ""), (True, "_max_st_o3m")])
def test_paths_match_jax(tmp_path, serialized, suffix):
    got = TP.PipelineConfig(tmp_path, serialized=serialized, config_suffix=suffix)
    want = JP.PipelineConfig(tmp_path, serialized=serialized, config_suffix=suffix)
    assert vars(got) == vars(want)
    p = tmp_path / "answers.json"
    assert TP.next_available_filename(p) == JP.next_available_filename(p) == p
    p.write_text("{}")
    assert TP.next_available_filename(p) == JP.next_available_filename(p) == \
        tmp_path / "answers_01.json"


def untimed(o):
    if isinstance(o, dict):
        return {k: untimed(v) for k, v in o.items()
                if k not in ("timing", "time", "timestamp", "duration")}
    if isinstance(o, list):
        return [untimed(v) for v in o]
    return o


def run_both(tmp_path, preset):
    """Every stage in both packages on two copies of the test set."""
    kw = dict(PRESETS[preset])
    rc = dataclasses.replace(JP.configs[kw.pop("base")], **kw)
    embed = hashed_embedder()
    out = {}
    for name, pkg, stub in (("port", TP, ExtractiveStubProvider),
                            ("jax", JP, JaxExtractive)):
        root = tmp_path / name
        shutil.copytree("data/test_set", root)
        extra = {"device": "cpu"} if pkg is TP else {}
        pipe = pkg.Pipeline(root, dataclasses.replace(rc), embedder=embed,
                            provider=stub(), **extra)
        pipe.parse_pdf_reports()
        pipe.process_parsed_reports()
        result = pipe.process_questions()
        out[name] = (pipe, result)
    return out


@pytest.mark.parametrize("preset", list(PRESETS))
def test_pipeline_stages_match_jax(tmp_path, preset):
    out = run_both(tmp_path, preset)
    (tp, tres), (jp, jres) = out["port"], out["jax"]
    for stage in ("parsed_reports_path", "merged_reports_path",
                  "reports_markdown_path", "documents_dir"):
        assert_same_dirs(getattr(tp.paths, stage), getattr(jp.paths, stage))
    assert_same_npz(tp.paths.index_path, jp.paths.index_path)
    assert tres["statistics"] == jres["statistics"]
    assert tres["statistics"]["total_questions"] == 5
    name = tp.paths.answers_file_path.name
    for f in (name, name.replace(".json", "_01.json"),
              name.replace(".json", "_01_debug.json")):
        got = json.loads((tp.paths.root_path / f).read_text("utf-8"))
        want = json.loads((jp.paths.root_path / f).read_text("utf-8"))
        assert untimed(got) == untimed(want), f
    proc = tp.build_processor()
    if PRESETS[preset].get("quantize_int8"):
        assert proc.engine.index.emb_scale is not None and proc.engine.ivf is not None
        assert proc.engine.window == 0                  # the cluster-ordered store
    assert proc.config.use_bm25 and proc.config.scan_rt == PRESETS[preset].get("scan_rt")


def _chunked_root(tmp_path):
    root = tmp_path / "set"
    shutil.copytree("data/test_set", root)
    pipe = TP.Pipeline(root, dataclasses.replace(TP.configs["offline"]), device="cpu")
    pipe.parse_pdf_reports()
    pipe.merge_reports()
    pipe.chunk_reports()
    return root, pipe


def test_create_vector_dbs_without_params_pretrains(tmp_path, monkeypatch, capsys):
    """With no embedder and no saved params, ``create_vector_dbs``
    pretrains the full-width encoder on the corpus on the pipeline's
    device (2 steps here), saves ``encoder_params.npz`` in the reference's
    layout (the JAX package's ``load_params`` reads it and embeds as the
    port does) and indexes with those weights."""
    import numpy as np
    import torch

    from rag_challenge_2_tpu.models.encoder import EmbeddingModel as JaxModel
    from rag_challenge_2_tpu.models.pretrain import load_params as jax_load
    from rag_challenge_2_tpu_torch.index import load_index

    root, pipe = _chunked_root(tmp_path)
    monkeypatch.delenv("RAGTPU_AUTO_PRETRAIN", raising=False)
    monkeypatch.setenv("RAGTPU_AUTO_PRETRAIN_STEPS", "2")
    params = pipe.paths.databases_path / "encoder_params.npz"
    pipe.create_vector_dbs()
    out = capsys.readouterr().out
    assert "ICT-pretraining 2 steps" in out and "loaded corpus-pretrained params" in out
    assert params.exists() and pipe.paths.index_path.exists()
    model = pipe.embedder.__self__
    jm = jax_load(JaxModel(), params)
    texts = ["金盘科技2024年营业收入", "研发费用"]
    a, b = model.embed(texts), np.asarray(jm.embed(texts))
    assert (a * b).sum(1).min() >= 0.999
    # the index holds the trained encoder's embeddings of the chunks
    idx, meta = load_index(pipe.paths.index_path, device="cpu")
    np.testing.assert_allclose(idx.emb[:2].numpy(), model.embed(meta.chunk_texts[:2]),
                               rtol=0, atol=1e-6)
    assert not torch.equal(model.module.tok_embed, torch.zeros_like(model.module.tok_embed))


def test_create_vector_dbs_skips_pretraining_when_asked(tmp_path, monkeypatch, capsys):
    """``RAGTPU_AUTO_PRETRAIN=0`` indexes with the seeded random weights and
    saves no params; a given embedder never pretrains."""
    root, pipe = _chunked_root(tmp_path)
    monkeypatch.setenv("RAGTPU_AUTO_PRETRAIN", "0")
    pipe.create_vector_dbs()
    params = pipe.paths.databases_path / "encoder_params.npz"
    assert pipe.paths.index_path.exists() and not params.exists()
    assert "randomly initialized weights" in capsys.readouterr().out
    monkeypatch.delenv("RAGTPU_AUTO_PRETRAIN")
    pipe.paths.index_path.unlink()
    TP.Pipeline(root, dataclasses.replace(TP.configs["offline"]),
                embedder=hashed_embedder(), device="cpu").create_vector_dbs()
    assert pipe.paths.index_path.exists() and not params.exists()


def test_run_e2e_pretrains_on_the_fixture(tmp_path):
    """``run_e2e(pretrain_steps=5)``: the encoder (max_len 128) pretrains on
    the fixture's lines (table pages included) before the pipeline runs."""
    from rag_challenge_2_tpu_torch.eval.e2e import fixture_lines, run_e2e

    lines = fixture_lines()
    assert lines and all(len(ln) >= 8 for ln in lines)
    res = run_e2e(tmp_path / "e2e", pretrain_steps=5, device="cpu")
    assert res["n"] == 17 and len(res["per_question"]) == 17
    assert 0.0 <= res["value_accuracy"] <= 1.0 and 0.0 <= res["page_hit"] <= 1.0


def test_pipeline_runs_on_the_card_unless_told(tmp_path, monkeypatch):
    import torch

    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        TP.Pipeline(tmp_path)
    assert TP.Pipeline(tmp_path, device="cpu").device.type == "cpu"


def test_cli_stages_on_the_test_set(tmp_path, monkeypatch, capsys):
    """The README's sequence through the port's command line on a copy of
    the test set (full-width encoder, seeded random weights): parse-pdfs →
    process-reports → query → process-questions → serve, plus the wide-k
    query and the other stages."""
    import threading
    import urllib.request

    root = tmp_path / "set"
    shutil.copytree("data/test_set", root)
    monkeypatch.setenv("RAGTPU_AUTO_PRETRAIN", "0")
    common = ["--root", str(root), "--device", "cpu"]
    cli.main(["parse-pdfs", *common, "--parser", "builtin"])
    cli.main(["process-reports", *common])
    out = capsys.readouterr().out.splitlines()
    assert out[0] == "parsed" and out[-1] == "index built"
    cli.main(["query", *common, "--company", "金盘科技", "--question",
              "2024年营业收入是多少", "--use-bm25", "--top-n", "3"])
    hits = [ln for ln in capsys.readouterr().out.splitlines() if ln.startswith("[")]
    assert len(hits) == 3 and all(" J202" in ln for ln in hits)
    cli.main(["query", *common, "--company", "金盘科技", "--question", "营业收入",
              "--top-n", "100", "--method", "ssg", "--neighbor-k", "100"])
    lines = capsys.readouterr().out.splitlines()
    assert lines and json.loads(lines[-1])
    cli.main(["process-questions", *common, "--config", "offline"])
    stats = json.loads(capsys.readouterr().out.splitlines()[-1])
    assert stats["total_questions"] == 5 and stats["error_count"] == 0
    assert (root / "answers_offline_01.json").exists()
    cli.main(["analyze-similarity", *common, "--doc", "1", "--out", str(tmp_path / "sim")])
    assert json.loads(capsys.readouterr().out.splitlines()[-1])["n_chunks"] > 0

    args = cli.build_parser().parse_args(["serve", *common, "--config", "offline",
                                          "--port", "0"])
    server = cli.build_server(args)
    t = threading.Thread(target=server.serve_forever, daemon=True)
    t.start()
    try:
        req = urllib.request.Request(
            f"http://127.0.0.1:{server.server_port}/api/ask",
            json.dumps({"question": "金盘科技2024年营业收入是多少？"}).encode(),
            headers={"Content-Type": "application/json"})
        out = json.loads(urllib.request.urlopen(req, timeout=300).read())
    finally:
        server.shutdown()
        server.server_close()
    t.join(timeout=10)
    assert "error" not in out and out.get("references") is not None
