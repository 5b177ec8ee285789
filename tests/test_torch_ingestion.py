"""The port's ingestion layer held against the JAX package's on the same
inputs, on the CPU.

The host copies (``splitter``, ``merging``, ``minipdf``, ``pdf``,
``tables``) must give equal JSON: outputs are compared as
``json.dumps(..., sort_keys=True)`` strings, so types, key order and NaN
count.  The ingestor's index must equal the JAX package's: the CSR and
every metadata column bitwise, the sidecar JSON equal, and the embedding
rows bitwise when both packages are given one numpy embedder, or within
the encoder port's tolerance (tests/test_torch_encoder.py: cosine >=
0.999, max abs diff <= 0.02) when each runs its own encoder on the same
weights.  Token counting is forced to the heuristic in both packages, so
a cached tiktoken file cannot split them."""

import copy
import dataclasses
import json
import zlib

import jax
import numpy as np
import pandas as pd
import pytest
import torch

import rag_challenge_2_tpu.ingestion as J
import rag_challenge_2_tpu.ingestion.minipdf as jax_minipdf
import rag_challenge_2_tpu.ingestion.pdf as jax_pdf
import rag_challenge_2_tpu.ingestion.splitter as jax_splitter
import rag_challenge_2_tpu_torch.ingestion as T
import rag_challenge_2_tpu_torch.ingestion.minipdf as port_minipdf
import rag_challenge_2_tpu_torch.ingestion.pdf as port_pdf
import rag_challenge_2_tpu_torch.ingestion.splitter as port_splitter
from rag_challenge_2_tpu.eval.e2e import fixture_docs, write_pdf
from rag_challenge_2_tpu.index.store import quantize_index as jax_quantize_index
from rag_challenge_2_tpu.llm import StubProvider as JaxStub
from rag_challenge_2_tpu.models.encoder import EmbeddingModel as JaxModel
from rag_challenge_2_tpu.models.encoder import EncoderConfig as JaxCfg
from rag_challenge_2_tpu_torch.index.store import quantize_index
from rag_challenge_2_tpu_torch.llm import StubProvider
from rag_challenge_2_tpu_torch.models.encoder import (
    EmbeddingModel, EncoderConfig, from_jax_params)
from tests.test_ingestion import (
    _build_table_pdf, _build_test_pdf, _parsed_report, _wrap_pdf)

# a narrow encoder: the layers and the numerics of the full one
SMALL = dict(vocab_bits=12, d_model=64, n_layers=2, n_heads=4, d_ff=128,
             max_len=128, out_dim=128)


REAL_ENCODING = port_splitter._encoding


@pytest.fixture(autouse=True)
def heuristic_tokens(monkeypatch):
    for mod in (jax_splitter, port_splitter):
        monkeypatch.setattr(mod, "_encoding", lambda: None)


def dumps(o):
    return json.dumps(o, ensure_ascii=False, sort_keys=True)


def assert_same_json(a, b):
    assert dumps(a) == dumps(b)


def assert_same_dirs(a, b):
    names = sorted(p.name for p in a.iterdir())
    assert names and names == sorted(p.name for p in b.iterdir())
    for n in names:
        assert (a / n).read_bytes() == (b / n).read_bytes(), n


def twin_encoders(seed=0, **cfg):
    """The JAX encoder and the port's on the same (flax-initialised)
    weights, the port's on the CPU."""
    cfg = {**SMALL, **cfg}
    jm = JaxModel(JaxCfg(**cfg), seed=seed)
    flat = {"/".join(str(getattr(k, "key", k)) for k in p): np.asarray(v)
            for p, v in jax.tree_util.tree_flatten_with_path(jm.params)[0]}
    return jm, EmbeddingModel(EncoderConfig(**cfg), params=from_jax_params(flat),
                              device="cpu")


def hashed_embedder(dim=32):
    """Unit rows seeded by each text's CRC: the same vectors in any batch."""
    def embed(texts):
        out = np.stack([np.random.default_rng(zlib.crc32(t.encode())).normal(size=dim)
                        for t in texts]).astype(np.float32)
        return out / np.linalg.norm(out, axis=1, keepdims=True)
    return embed


# ---------------------------------------------------------------- merging

MERGE_CASES = {
    "footers_pictures": ([{"type": "text", "text": "正文"},
                          {"type": "page_footer", "text": "第1页"},
                          {"type": "picture", "text": ""}], None, {}),
    "header_levels": ([{"type": "page_header", "text": "年度报告"},
                       {"type": "section_header", "text": "财务概要"},
                       {"type": "text", "text": "内容"}], None, {}),
    "table_footnote": ([{"type": "text", "text": "主要数据如下："},
                        {"type": "table", "table_id": 0, "text": ""},
                        {"type": "footnote", "text": "注：单位为万元"}],
                       [{"table_id": 0, "page": 1,
                         "markdown": "|指标|数值|\n|--|--|\n|营收|100|"}], {}),
    "list_group": ([{"type": "text", "text": "主要产品："},
                    {"type": "list_item", "text": "干式变压器"},
                    {"type": "list_item", "text": "储能系统"}], None, {}),
    "serialized_instead": ([{"type": "table", "table_id": 0, "text": ""}],
                           [{"table_id": 0, "page": 1, "markdown": "|a|b|",
                             "serialized": {"information_blocks": [
                                 {"subject_core_entity": "营收",
                                  "information_block": "2024年营收为100亿元"}]}}],
                           dict(use_serialized_tables=True,
                                serialized_tables_instead_of_markdown=True)),
    "serialized_beside": ([{"type": "text", "text": "上文"},
                           {"type": "table", "table_id": 0, "text": ""}],
                          [{"table_id": 0, "page": 1, "markdown": "|a|b|",
                            "serialized": {"information_blocks": [
                                {"subject_core_entity": "营收",
                                 "information_block": "营收100亿元"}]}}],
                          dict(use_serialized_tables=True)),
    "unknown_types_and_glyphs": ([{"type": "hologram", "text": "x"},
                                  {"type": "title", "text": "年度报告"},
                                  {"type": "text", "text":
                                   "营收/one.tnum/zero.tnum/percent.tnum glyph<c=3,font=F4>增长"}],
                                 None, {}),
}


@pytest.mark.parametrize("case", list(MERGE_CASES))
def test_merging_matches_jax(case):
    blocks, tables, kw = MERGE_CASES[case]
    rep = _parsed_report(blocks, tables)
    assert_same_json(T.PageTextPreparation(**kw).process_report(rep),
                     J.PageTextPreparation(**kw).process_report(rep))


@pytest.mark.parametrize("text", [
    "营收/one.tnum/zero.tnum/percent.tnum glyph<c=3,font=F4>增长",
    "plain text", "/period.tnum/five.tnum glyph<c=1,font=/AB>"])
def test_clean_text_matches_jax(text):
    assert T.clean_text(text) == J.clean_text(text)


# --------------------------------------------------------------- splitter

LONG = "".join(
    f"第{i}段：公司{2020 + i % 5}年营业收入为{i * 3.7:.2f}亿元，同比增长{i % 17}%。"
    + ("\n\n" if i % 7 == 0 else "") for i in range(120))


@pytest.mark.parametrize("size,overlap", [(300, 50), (64, 16), (40, 0)])
def test_split_text_matches_jax(size, overlap):
    got = T.split_text(LONG, size, overlap)
    assert len(got) > 1 and got == J.split_text(LONG, size, overlap)
    assert [T.count_tokens(t) for t in got] == [J.count_tokens(t) for t in got]


def test_split_report_matches_jax():
    merged = {"metainfo": {"sha1_name": "J2024_t"},
              "content": {"pages": [{"page": 1, "text": LONG},
                                    {"page": 2, "text": ""},
                                    {"page": 3, "text": "短页"}]}}
    ser = _parsed_report([{"type": "table", "table_id": 0}], [{
        "table_id": 0, "page": 3, "serialized": {"information_blocks": [
            {"subject_core_entity": "营收", "information_block": "营收100亿元"}]}}])
    assert_same_json(T.TextSplitter().split_report(copy.deepcopy(merged), ser),
                     J.TextSplitter().split_report(copy.deepcopy(merged), ser))


@pytest.mark.parametrize("cache", ["unset", "missing", "corrupt"])
def test_port_tokenizer_never_downloads(tmp_path, monkeypatch, cache):
    """The port's token counter asks tiktoken only for a BPE file that lies,
    intact, in the cache the environment names; otherwise it counts by the
    heuristic and tiktoken is never imported (it would download)."""
    import hashlib
    import sys

    monkeypatch.setattr(port_splitter, "_enc", None)
    monkeypatch.setattr(port_splitter, "_enc_failed", False)
    monkeypatch.setitem(sys.modules, "tiktoken", None)     # importing it fails
    monkeypatch.delenv("DATA_GYM_CACHE_DIR", raising=False)
    if cache == "unset":
        monkeypatch.delenv("TIKTOKEN_CACHE_DIR", raising=False)
    else:
        monkeypatch.setenv("TIKTOKEN_CACHE_DIR", str(tmp_path))
    if cache == "corrupt":
        key = hashlib.sha1(port_splitter._BPE_URL.encode()).hexdigest()
        (tmp_path / key).write_bytes(b"not the BPE file")
    assert not port_splitter._bpe_cached()
    assert REAL_ENCODING() is None and port_splitter._enc_failed
    assert port_splitter.count_tokens("营业收入 grew") == jax_splitter._heuristic_tokens(
        "营业收入 grew")


# ---------------------------------------------------------------- minipdf

PDFS = {"ascii_cjk": _build_test_pdf, "table": _build_table_pdf}
PDFS.update({d["sha1"]: (lambda d=d: write_pdf(d["pages"])) for d in fixture_docs()[:2]})


@pytest.mark.parametrize("name", list(PDFS))
def test_minipdf_matches_jax(name):
    data = PDFS[name]()
    got = port_minipdf.extract_pdf_pages_structured(data)
    assert got and got == jax_minipdf.extract_pdf_pages_structured(data)
    assert port_minipdf.extract_pdf_pages(data) == jax_minipdf.extract_pdf_pages(data)


def test_minipdf_encrypted_raises_in_both():
    data = _wrap_pdf({1: b"<< /Type /Catalog /Pages 2 0 R >>",
                      2: b"<< /Type /Pages /Kids [] /Count 0 >>"},
                     trailer=b"trailer << /Root 1 0 R /Encrypt 9 0 R >>")
    for mod in (port_minipdf, jax_minipdf):
        with pytest.raises(ValueError, match="encrypted"):
            mod.extract_pdf_pages(data)


# -------------------------------------------------------------------- pdf

SUBSETS = {
    "full": "sha1,company_name,year\nA2023_x,金盘科技,2023\nB2024_y,宁德时代,2024\n",
    # an empty year makes the column float; an empty name reads as NaN
    "empty_cells": "sha1,company_name,year\nA2023_x,,2023\nB2024_y,宁德时代,\n",
    "na_words_and_extra_column": ("sha1,company_name,year,sector\nA2023_x,None,2023.0,"
                                  "电气\nB2024_y,NA,2024,12\n"),
    "numeric_names": "sha1,company_name,year\nA2023_x,600519,2023\nB2024_y,300750,2024\n",
    "missing_sha1": "sha1,company_name,year\nC2020_z,某公司,2020\n",
}


@pytest.mark.parametrize("subset", list(SUBSETS))
def test_metainfo_matches_pandas(tmp_path, subset):
    """``read_subset`` types subset.csv as pandas does, so the metainfo
    (NaN for an empty name, no year for an empty year) equals the JAX
    package's."""
    path = tmp_path / "subset.csv"
    path.write_text(SUBSETS[subset], encoding="utf-8")
    rows = port_pdf.read_subset(path)
    frame = pd.read_csv(path)
    for sha in ("A2023_x", "B2024_y", "C2020_z"):
        assert_same_json(port_pdf._metainfo_for(sha, rows),
                         jax_pdf._metainfo_for(sha, frame))


@pytest.mark.parametrize("source", ["test_set", "fixture_pdfs"])
def test_plain_text_parser_matches_jax(tmp_path, source):
    """``PlainTextParser`` over the repo's test set (.txt) and the e2e
    fixture's PDFs (tables included): the parsed reports byte for byte,
    then merging and chunking of them."""
    import shutil

    from rag_challenge_2_tpu.eval.e2e import build_fixture

    root = tmp_path / "root"
    if source == "test_set":
        shutil.copytree("data/test_set", root)
    else:
        build_fixture(root)
    inputs = sorted((root / "pdf_reports").glob("*"))
    outs = {}
    for name, pkg in (("port", T), ("jax", J)):
        parsed = tmp_path / name / "parsed"
        pkg.get_parser(parsed, root / "subset.csv", kind="builtin").parse_and_export(inputs)
        pkg.PageTextPreparation().process_reports(parsed, tmp_path / name / "merged")
        pkg.PageTextPreparation().export_to_markdown(tmp_path / name / "merged",
                                                     tmp_path / name / "md")
        pkg.TextSplitter().split_all_reports(tmp_path / name / "merged",
                                             tmp_path / name / "chunked")
        outs[name] = tmp_path / name
    for stage in ("parsed", "merged", "md", "chunked"):
        assert_same_dirs(outs["port"] / stage, outs["jax"] / stage)


def test_get_parser_kinds_match_jax(tmp_path):
    for kind in ("auto", "builtin", "text"):
        assert type(T.get_parser(tmp_path, kind=kind)).__name__ == \
            type(J.get_parser(tmp_path, kind=kind)).__name__ == "PlainTextParser"
    for pkg in (T, J):
        with pytest.raises(ValueError, match="unknown parser kind"):
            pkg.get_parser(tmp_path, kind="ocr")
        with pytest.raises(ImportError, match="docling is not installed"):
            pkg.get_parser(tmp_path, kind="docling")
    pages = [{"page": 3, "content": []}, {"page": 1, "content": []}]
    assert_same_json(T.normalize_page_sequence(pages), J.normalize_page_sequence(pages))


def test_assemble_report_matches_jax(tmp_path):
    """The docling-dict assembly (groups nested, a table, a picture with a
    text child, two pages) and the metadata it reads from subset.csv."""
    prov = lambda page: [{"page_no": page, "bbox": {"l": 1, "t": 2, "r": 3, "b": 4}}]  # noqa: E731
    data = {
        "texts": [{"text": "标题", "label": "section_header", "prov": prov(1)},
                  {"text": "正文", "orig": "正 文", "label": "text", "prov": prov(1)},
                  {"text": "项", "label": "list_item", "enumerated": True,
                   "marker": "1.", "prov": prov(2)},
                  {"text": "图注", "label": "caption", "prov": prov(2)}],
        "groups": [{"name": "list", "label": "list",
                    "children": [{"$ref": "#/texts/2"}, {"$ref": "#/groups/1"}]},
                   {"name": "inner", "label": "list", "children": [{"$ref": "#/texts/1"}]}],
        "tables": [{"self_ref": "#/tables/0", "prov": prov(2), "data": {
            "num_rows": 2, "num_cols": 2, "grid": [
                [{"text": "项目", "column_header": True}, {"text": "数值", "column_header": True}],
                [{"text": "营收"}, {"text": "100"}]]}}],
        "pictures": [{"self_ref": "#/pictures/0", "prov": prov(2),
                      "children": [{"$ref": "#/texts/3"}]}],
        "pages": [{}, {}],
        "body": {"children": [{"$ref": "#/texts/0"}, {"$ref": "#/groups/0"},
                              {"$ref": "#/tables/0"}, {"$ref": "#/pictures/0"}]},
    }
    path = tmp_path / "subset.csv"
    path.write_text(SUBSETS["empty_cells"], encoding="utf-8")
    assert_same_json(
        port_pdf.assemble_report(data, "A2023_x", port_pdf.read_subset(path)),
        jax_pdf.assemble_report(data, "A2023_x", pd.read_csv(path)))


def test_table_serializer_matches_jax(tmp_path):
    blocks = {"subject_core_entities_list": ["营收"],
              "information_blocks": [
                  {"subject_core_entity": "营收", "information_block": "2024年营收100亿"}]}
    rep = _parsed_report(
        [{"type": "text", "text": "上文"}, {"type": "table", "table_id": 0, "text": ""},
         {"type": "text", "text": "下文"}],
        tables=[{"table_id": 0, "page": 1, "html": "<table>...</table>"}])
    src = tmp_path / "in"
    src.mkdir()
    (src / "r.json").write_text(json.dumps(rep, ensure_ascii=False), encoding="utf-8")
    calls = []
    for name, pkg, stub in (("port", T, StubProvider), ("jax", J, JaxStub)):
        provider = stub({"表格": json.dumps(blocks, ensure_ascii=False)})
        pkg.TableSerializer(provider).process_directory_parallel(src, tmp_path / name)
        calls.append(provider.calls)
    assert_same_dirs(tmp_path / "port", tmp_path / "jax")
    assert calls[0] == calls[1] and calls[0]


# --------------------------------------------------------------- ingestor

def chunked_fixture(tmp_path):
    """The e2e fixture's six reports through the JAX package's parse →
    merge → chunk (the host stages are held equal above), plus a report
    with no chunks."""
    from rag_challenge_2_tpu.eval.e2e import build_fixture

    root = tmp_path / "fixture"
    build_fixture(root)
    J.get_parser(tmp_path / "parsed", root / "subset.csv", kind="builtin") \
        .parse_and_export(sorted((root / "pdf_reports").glob("*.pdf")))
    J.PageTextPreparation().process_reports(tmp_path / "parsed", tmp_path / "merged")
    J.TextSplitter().split_all_reports(tmp_path / "merged", tmp_path / "chunked")
    empty = {"metainfo": {"sha1_name": "Z2024_empty", "company_name": "空公司",
                          "year": 2024}, "content": {"pages": [], "chunks": []}}
    (tmp_path / "chunked" / "Z2024_empty.json").write_text(
        json.dumps(empty, ensure_ascii=False), encoding="utf-8")
    return tmp_path / "chunked"


def assert_same_npz(port_path, jax_path, emb_close=None):
    with np.load(port_path) as a, np.load(jax_path) as b:
        assert sorted(a.files) == sorted(b.files)
        for key in a.files:
            if key == "emb" and emb_close is not None:
                emb_close(a[key], b[key])
            else:
                np.testing.assert_array_equal(a[key], b[key], err_msg=key)
    assert (port_path.parent / (port_path.name + ".meta.json")).read_text("utf-8") == \
        (jax_path.parent / (jax_path.name + ".meta.json")).read_text("utf-8")


def assert_close_embeddings(a, b):
    """tests/test_torch_encoder.py's tolerance; zero (padding) rows equal."""
    live = np.linalg.norm(b, axis=1) > 0
    np.testing.assert_array_equal(np.linalg.norm(a, axis=1) > 0, live)
    a, b = a[live], b[live]
    assert ((a * b).sum(1) / (np.linalg.norm(a, axis=1) * np.linalg.norm(b, axis=1))).min() >= 0.999
    assert np.abs(a - b).max() <= 0.02


@pytest.mark.parametrize("embedder", ["numpy", "encoders"])
def test_process_reports_npz_matches_jax(tmp_path, embedder):
    """``CorpusIngestor.process_reports`` over the chunked fixture (one
    report without chunks: its ``(0, D)`` placeholder): the saved npz and
    sidecar equal the JAX package's, the CSR bitwise; the embedding rows
    bitwise with one numpy embedder, within the encoder tolerance with
    each package's encoder on the same weights."""
    chunked = chunked_fixture(tmp_path)
    if embedder == "numpy":
        port_embed = jax_embed = hashed_embedder()
        close = None
    else:
        jm, tm = twin_encoders()
        port_embed, jax_embed, close = tm.embed, jm.embed, assert_close_embeddings
    T.CorpusIngestor(port_embed, batch_size=16, device="cpu").process_reports(
        chunked, tmp_path / "port.npz")
    J.CorpusIngestor(jax_embed, batch_size=16).process_reports(
        chunked, tmp_path / "jax.npz")
    assert_same_npz(tmp_path / "port.npz", tmp_path / "jax.npz", close)


def test_embed_reports_probes_the_dim_when_every_report_is_empty():
    empty = [{"metainfo": {}, "content": {"pages": [], "chunks": []}}] * 2
    got = T.CorpusIngestor(hashed_embedder(24), device="cpu").embed_reports(empty)
    want = J.CorpusIngestor(hashed_embedder(24)).embed_reports(empty)
    assert [e.shape for e in got] == [e.shape for e in want] == [(0, 24)] * 2


@pytest.mark.parametrize("store", ["float32", "int8"])
def test_add_reports_matches_jax_and_a_fresh_build(tmp_path, store):
    """``add_reports`` splices two reports into an index of four (int8:
    dequantized first, as ``ops/quant`` stores it): equal to the JAX
    package's splice, and the f32 splice equal to a fresh build of all six."""
    from rag_challenge_2_tpu.index.build import load_chunked_reports

    reports = load_chunked_reports(chunked_fixture(tmp_path))
    embed = hashed_embedder()
    port_ing = T.CorpusIngestor(embed, device="cpu")
    jax_ing = J.CorpusIngestor(embed)
    idx, meta = port_ing.build(reports[:4])
    jidx, jmeta = jax_ing.build(reports[:4])
    if store == "int8":
        idx, jidx = quantize_index(idx), jax_quantize_index(jidx)
        np.testing.assert_array_equal(idx.emb.numpy(), np.asarray(jidx.emb))
    got, got_meta = port_ing.add_reports(idx, meta, reports[4:])
    want, want_meta = jax_ing.add_reports(jidx, jmeta, reports[4:])
    for name in ("emb", "doc_id", "page", "year", "company_id", "kind",
                 "page_seg", "chunk_in_doc", "valid"):
        np.testing.assert_array_equal(getattr(got, name).numpy(),
                                      np.asarray(getattr(want, name)), err_msg=name)
    for name in ("indptr", "chunk_ids", "tf", "df", "chunk_len", "dl"):
        np.testing.assert_array_equal(getattr(got.sparse, name).numpy(),
                                      np.asarray(getattr(want.sparse, name)), err_msg=name)
    assert dataclasses.asdict(got_meta) == dataclasses.asdict(want_meta)
    fresh, fresh_meta = port_ing.build(reports)
    assert got_meta == fresh_meta
    if store == "float32":
        assert torch.equal(got.emb, fresh.emb)
    else:       # the dequantized rows of the first four reports
        n_old = idx.n_chunks
        deq = idx.emb[:n_old].float() * idx.emb_scale[:n_old, None]
        assert torch.equal(got.emb[:n_old], deq)
        assert torch.equal(got.emb[n_old:], fresh.emb[n_old:])
