"""The web QA frontend: the JAX package's server and the port's, each on
its own processor over the same corpus, embedder and scripted stub
(``tests/test_torch_qa.py``), driven over HTTP with the same requests.
Every endpoint's decoded JSON must be equal, types included (a tensor or
numpy scalar left in a payload would come out of ``json.dumps(...,
default=str)`` as a string), ``timing`` excepted; scores within 1e-5."""

import json
import threading
import urllib.error
import urllib.request
from concurrent.futures import ThreadPoolExecutor

import pytest

from rag_challenge_2_tpu.serving import QAWebApp as JaxWebApp
from rag_challenge_2_tpu_torch.serving import QAWebApp
from tests.test_torch_qa import qa_corpus  # noqa: F401  (the shared fixture)
from tests.test_torch_qa import build_pair, plain_types, same


@pytest.fixture(scope="module")
def servers(qa_corpus, tmp_path_factory):
    pdf_dir = tmp_path_factory.mktemp("pdf")
    (pdf_dir / "S2023_doc0.pdf").write_bytes(b"%PDF-1.4\nfixture-bytes\n%%EOF\n")
    (jp, js), (tp, ts) = build_pair(qa_corpus, dict(use_bm25=True))
    out = []
    for App, proc, stub in ((JaxWebApp, jp, js), (QAWebApp, tp, ts)):
        server = App(proc, default_company="金盘科技", pdf_dir=pdf_dir).make_server(port=0)
        threading.Thread(target=server.serve_forever, daemon=True).start()
        out.append((f"http://127.0.0.1:{server.server_port}", stub, server))
    yield out
    for _, _, server in out:
        server.shutdown()
        server.server_close()


def get(url):
    with urllib.request.urlopen(url, timeout=60) as r:
        return r.headers["Content-Type"], r.read()


def post(url, path, payload):
    req = urllib.request.Request(url + path, json.dumps(payload).encode(),
                                 headers={"Content-Type": "application/json"})
    with urllib.request.urlopen(req, timeout=120) as r:
        return json.loads(r.read())


def both_post(servers, path, payload):
    (ju, js, _), (tu, ts, _) = servers
    js.calls.clear()
    ts.calls.clear()
    jo, to = post(ju, path, payload), post(tu, path, payload)
    plain_types(to)
    same(to, jo)
    assert sorted(c["user"] for c in ts.calls) == sorted(c["user"] for c in js.calls)
    return to


def test_index_page(servers):
    (ju, _, _), (tu, _, _) = servers
    (jt, jhtml), (tt, thtml) = get(ju + "/"), get(tu + "/")
    assert tt == jt == "text/html; charset=utf-8"
    thtml, jhtml = thtml.decode(), jhtml.decode()
    # the page names the device it runs on; the rest is the same client
    assert "(GPU)" in thtml and "PyTorch + CUDA" in thtml
    assert thtml.replace("(GPU)", "(TPU)").replace("PyTorch + CUDA", "TPU-native") == jhtml
    assert get(tu + "/index.html")[1].decode() == thtml


@pytest.mark.parametrize("path", [
    "/api/bank",
    "/api/page?doc=S2023_doc0&page=1",
    "/api/page?doc=S2024_doc1&page=3",
    "/api/page?doc=S2023_doc0&page=99",
    "/api/page?doc=x&page=abc",
])
def test_get_endpoints(servers, path):
    (ju, _, _), (tu, _, _) = servers
    (jt, jb), (tt, tb) = get(ju + path), get(tu + path)
    assert tt == jt == "application/json"
    to = json.loads(tb)
    plain_types(to)
    same(to, json.loads(jb))
    if path.endswith("page=1"):
        assert to["pdf_url"] == "/api/pdf?doc=S2023_doc0#page=1"


def test_pdf_and_not_found(servers):
    (ju, _, _), (tu, _, _) = servers
    assert get(tu + "/api/pdf?doc=S2023_doc0") == get(ju + "/api/pdf?doc=S2023_doc0")
    for path in ("/api/pdf?doc=nope", "/api/pdf?doc=..%2FS2023_doc0", "/nope"):
        codes = []
        for url in (ju, tu):
            with pytest.raises(urllib.error.HTTPError) as e:
                get(url + path)
            codes.append((e.value.code, e.value.read()))
        assert codes[0] == codes[1] and codes[1][0] == 404
    for url in (ju, tu):
        req = urllib.request.Request(url + "/api/nope", b"{}")
        with pytest.raises(urllib.error.HTTPError) as e:
            urllib.request.urlopen(req, timeout=60)
        assert e.value.code == 404


ASKS = {
    "basic": {"question": "2023年营业收入是多少", "method": "basic", "schema": "number",
              "top_n": 5},
    "company_named": {"question": "金盘科技2024年毛利率是多少"},
    "ssg_years": {"question": "营业收入", "method": "ssg", "max_hops": 2, "neighbor_k": 4,
                  "years": [2023]},
    "triangulation": {"question": "研发投入", "method": "triangulation", "max_hops": 2,
                      "neighbor_k": 4},
    "hybrid_expansion": {"question": "净利润", "method": "hybrid_expansion"},
    "rerank_upstream": {"question": "海外收入", "llm_reranking": True, "sample_size": 8,
                        "expand_upstream": True, "expand_top_k": 2,
                        "expand_context_size": 1},
    "expansion": {"question": "2023年营业收入是多少", "use_hyde": True,
                  "use_multi_query": True},
    "history": {"question": "那净利润呢", "history": [{"question": "2023年营收",
                                                    "answer": "68.9"}]},
    "empty": {"question": "  "},
    "other_company": {"question": "宁德时代2023年营业收入"},
    "bad_method": {"question": "营业收入", "method": "nope"},
    "bad_int": {"question": "营业收入", "top_n": "x"},
}


@pytest.mark.parametrize("name", list(ASKS))
def test_ask_matches(servers, name):
    out = both_post(servers, "/api/ask", ASKS[name])
    if name == "empty":
        assert out == {"error": "empty question"}
    elif name.startswith("bad"):
        assert "error" in out
    else:
        assert "error" not in out and out["final_answer"] == 68.9


def test_eval_endpoints_match(servers):
    out = both_post(servers, "/api/eval", {"records": [
        {"question": "2024年营收是多少", "standard_answer": "68.9亿", "rag_answer": "68.9亿"}]})
    assert out["statistics"]["accuracy"] == 1.0
    assert "error" in both_post(servers, "/api/eval", {"records": []})
    run = both_post(servers, "/api/eval_run", {
        "records": [{"question": "2023年营业收入是多少", "standard_answer": "68.9"},
                    {"question": "毛利率", "standard_answer": "30%"},
                    {"question": " ", "standard_answer": "x"}],
        "method": "basic", "top_n": 5, "parallel_requests": 1})
    assert run["statistics"]["total"] == 3 and run["records"][0]["references"]
    assert "error" in both_post(servers, "/api/eval_run", {"records": "x"})


def test_concurrent_asks_equal_serial(servers):
    """8 asks at once on the port's server (each on its own thread over a
    shallow copy of the processor) equal the same asks one by one."""
    (_, _, _), (tu, _, _) = servers
    qs = [{"question": q, "method": m} for q, m in (
        ("2023年营业收入是多少", "basic"), ("毛利率", "basic"), ("研发投入", "ssg"),
        ("净利润", "basic"), ("海外收入", "hybrid_expansion"), ("现金分红", "basic"),
        ("2024年营业收入", "triangulation"), ("营业收入", "basic"))]
    serial = [post(tu, "/api/ask", q) for q in qs]
    with ThreadPoolExecutor(8) as ex:
        concurrent = list(ex.map(lambda q: post(tu, "/api/ask", q), qs))
    for a, b in zip(concurrent, serial):
        assert "error" not in a
        same(a, b)
