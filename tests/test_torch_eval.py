"""The port's ``eval.scorer`` and ``eval.judge`` held against the JAX
package's on the same inputs (pure host code: outputs must be equal)."""

import dataclasses
import json

import pytest

import rag_challenge_2_tpu.eval as jeval
import rag_challenge_2_tpu.llm as jllm
import rag_challenge_2_tpu_torch.eval as teval
import rag_challenge_2_tpu_torch.llm as tllm
from tests.test_torch_llm import exported



def test_exports_match():
    assert exported(teval) == exported(jeval)
    assert all(hasattr(teval, n) for n in exported(teval))


COMPARE_CASES = [
    ("number", "100", 100.9), ("number", "100", 101.1), ("number", "100", "abc"),
    ("number", "N/A", "N/A"), ("number", "100", "N/A"), ("number", "N/A", 100),
    ("number", "-5.5", -5.52), ("number", "0", 0), ("number", "1,000", 1000),
    ("boolean", "True", True), ("boolean", "true", False), ("boolean", "False", "no"),
    ("name", " ABC Corp ", "abc corp"), ("name", "x", None),
    ("names", "a,b", ["a", "b"]), ("names", "a,b", ["a", "c"]), ("names", "a,b", "a, b"),
    ("names", "", []),
]


@pytest.mark.parametrize("kind,answer,predicted", COMPARE_CASES)
def test_compare_matches(kind, answer, predicted):
    def run(m):
        try:
            return m.compare(kind, answer, predicted)
        except Exception as e:          # both must fail alike
            return type(e).__name__

    assert run(teval) == run(jeval)


@pytest.mark.parametrize("refs,pools", [
    (["s1:1", "s2:5"], [["s1:1", "s1:2"], ["s2:5"]]),
    (["s1:1", "s2:5", "bogus:9"], [["s1:1", "s1:2"], ["s2:5"]]),
    (["s1:1"], [["s1:1", "s1:2"], ["s2:5"]]),
    (["x:1"] * 20, [["s1:1"]]),
    ([], []),
    (["a:0"], []),
])
def test_reference_score_matches(refs, pools):
    assert teval.reference_score(refs, pools) == jeval.reference_score(refs, pools)


def _score(ev):
    canonic = {
        "q1": ev.CanonicData(kind="number", answers=["100"], reference_pools=[["s:0"]]),
        "q2": ev.CanonicData(kind="name", answers=["ACME"], reference_pools=[]),
        "q3": ev.CanonicData(kind="number", answers=[], reference_pools=[]),
        "q4": ev.CanonicData(kind="boolean", answers=["true"], reference_pools=[["t:3"]]),
    }
    sub = ev.AnswerSubmission(answers=[
        ev.Answer(question_text="q1", kind="number", value=100.5,
                  references=[{"pdf_sha1": "s", "page_index": 0}]),
        ev.Answer(question_text="q2", kind="name", value="acme"),
        ev.Answer(question_text="q3", kind="number", value=1),
    ])
    return dataclasses.asdict(ev.score_submission(sub, canonic))


def test_score_submission_matches():
    out = _score(teval)
    assert out == _score(jeval)
    assert out["score"] == 3.0 and out["missing"] == 1 and out["no_rank"] == 1


def _rank(ev, root):
    answers = {
        "q1": {"kind": "number", "answers": ["100"], "reference_pools": [["s:0"]]},
        "q2": {"kind": "boolean", "answers": ["true"], "reference_pools": []},
    }
    (root / "answers.json").write_text(json.dumps(answers))
    subs = root / "subs"
    subs.mkdir()
    (subs / "a.json").write_text(json.dumps({
        "submission_name": "good", "team_email": "", "signature": "",
        "answers": [
            {"question_text": "q1", "kind": "number", "value": 100,
             "references": [{"pdf_sha1": "s", "page_index": 0}]},
            {"question_text": "q2", "kind": "boolean", "value": True, "references": []},
        ],
    }))
    (subs / "b.json").write_text(json.dumps({
        "submission_name": "bad", "team_email": "", "signature": "",
        "answers": [{"question_text": "q1", "kind": "number", "value": 50,
                     "references": []}],
    }))
    scores = ev.rank_submissions(subs, root / "answers.json",
                                 csv_out=root / "ranking.csv")
    return [dataclasses.asdict(s) for s in scores], (root / "ranking.csv").read_text()


def test_rank_submissions_matches(tmp_path):
    (tmp_path / "j").mkdir()
    (tmp_path / "t").mkdir()
    jo, to = _rank(jeval, tmp_path / "j"), _rank(teval, tmp_path / "t")
    assert to == jo
    assert to[0][0]["submission_name"] == "good"


def _judge(ev, llm, root):
    harness = ev.JudgeHarness(llm.LLMFacade(llm.StubProvider({
        "标准答案": json.dumps({"score": 1.0, "reasoning": "一致", "is_correct": True}),
    })))
    records = [
        {"question": "2024年营收是多少", "standard_answer": "100亿", "rag_answer": "100亿"},
        {"question": "是否分红", "standard_answer": "是", "rag_answer": "是"},
        {"question": "介绍主营业务", "standard_answer": "变压器", "rag_answer": "储能"},
    ]
    judged = harness.judge_all(records, root / "eval.json")
    saved = json.loads((root / "eval.json").read_text())
    path = root / "fix.json"
    path.write_text(json.dumps({"records": [
        {"question": "q收入1", "standard_answer": "1", "rag_answer": "1",
         "evaluation": {"score": 1.0, "reasoning": "好", "is_correct": True}},
        {"question": "q收入2", "standard_answer": "2", "rag_answer": "2",
         "evaluation": {"score": 0.0, "reasoning": "", "is_correct": False}},
        {"question": "q3", "standard_answer": "3", "rag_answer": "3", "error": "x"},
    ]}, ensure_ascii=False))
    fixed = harness.fix_evaluation_results(path)
    fixed.pop("backup")
    return judged, saved, fixed, json.loads(path.read_text()), \
        ev.summarize(judged["records"])


def test_judge_matches(tmp_path):
    (tmp_path / "j").mkdir()
    (tmp_path / "t").mkdir()
    jo = _judge(jeval, jllm, tmp_path / "j")
    to = _judge(teval, tllm, tmp_path / "t")
    assert to == jo
    assert to[0]["statistics"]["accuracy"] == 1.0 and to[2]["fixed"] == 2
    assert list((tmp_path / "t").glob("fix.bak-*.json"))
