"""BENCHMARK.json and the files the harness finds by name."""

import json
import re

import pytest

from benchmark import check, harness

SPEC = harness.bench()
NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.-]{1,16}$")


def test_top_level_keys():
    assert list(SPEC) == ["command", "paths", "run_seconds", "configs", "workloads",
                          "end_to_end", "per_layer"]
    assert SPEC["paths"] == ["benchmark"]
    assert 1 <= SPEC["run_seconds"] <= 51


@pytest.mark.parametrize("cfg", SPEC["configs"], ids=lambda c: c["name"])
def test_configuration_file_found_by_name(cfg):
    assert cfg["file"] == f"benchmark/configs/{cfg['name']}.json"
    body = harness.load("configs", cfg["name"])
    assert body["source"] == cfg["source"] and body["reduced"] == cfg["reduced"]
    assert NAME.match(cfg["name"])


@pytest.mark.parametrize("cell", SPEC["workloads"], ids=lambda c: c["name"])
def test_cell_files_found_by_name(cell):
    assert cell["name"] == f"{cell['config']}.{cell['traffic']}"
    assert NAME.match(cell["name"]) and cell["chips"] == 1
    assert len(cell["why"]) <= 200 and "\n" not in cell["why"]
    harness.load("configs", cell["config"])
    mix = harness.load("traffic", cell["traffic"])
    assert mix["loop"] in ("scan", "clients")
    limits = harness.load("limits", cell["name"])
    assert limits["mode"] in ("int8", "bf16", "f32")
    assert limits["limits"]


@pytest.mark.parametrize("metric", SPEC["end_to_end"] + SPEC["per_layer"],
                         ids=lambda m: m["name"])
def test_metric_reader_found_by_name(metric):
    assert NAME.match(metric["name"]) and UNIT.match(metric["unit"])
    assert metric["better"] in ("lower", "higher")
    assert callable(harness.reader(metric["name"]))
    cells = {w["name"] for w in SPEC["workloads"]}
    assert set(metric.get("workloads", cells)) <= cells
    if "moves" in metric:
        assert metric["moves"] in {m["name"] for m in SPEC["end_to_end"]}


def test_every_cell_reports_setup_another_end_to_end_and_a_layer():
    for cell in SPEC["workloads"]:
        def has(ms):
            return [m["name"] for m in ms if cell["name"] in m.get("workloads", [cell["name"]])]
        e2e = has(SPEC["end_to_end"])
        assert "setup_s" in e2e and len(e2e) >= 2
        assert has(SPEC["per_layer"])


def test_file_is_small_and_plain():
    text = (harness.ROOT / "BENCHMARK.json").read_text()
    assert len(text.encode()) <= 64 * 1024
    json.loads(text)


def test_an_unlisted_cell_is_found_by_its_files():
    cell = harness.unlisted_cell("flat10m_int8.hybrid_c1")
    assert cell["config"] == "flat10m_int8" and cell["traffic"] == "hybrid_c1"
    assert {m["name"]: m["unit"] for m in cell["per_layer"]} == {
        "bm25.stage_ms": "ms", "engine.dispatch_ms": "ms", "fuse.host_ms": "ms",
        "encoder.mfu": "%"}
    assert harness.unlisted_cell("flat10m_int8.nothing") is None


LIMITS = sorted(p.stem for p in (harness.HERE / "limits").glob("*.json"))
MODEL_FUNCTIONS = ("init", "forward", "flops", "bytes", "token_space", "compute_type")


@pytest.mark.parametrize("name", LIMITS)
def test_every_measured_cell_has_its_files(name):
    """Listed or not: a configuration, a mix for one of the three loops, and
    limits; a mix of the ``encode`` loop runs a configuration with a
    ``model`` section whose reference file exists, and its check limits
    ``embed_gap``."""
    cell = harness.unlisted_cell(name) or {w["name"]: w for w in SPEC["workloads"]}[name]
    assert NAME.match(name) and cell["chips"] == 1
    cfg = harness.load("configs", cell["config"])
    mix = harness.load("traffic", cell["traffic"])
    limits = harness.load("limits", name)
    assert mix["loop"] in ("scan", "clients", "encode")
    assert limits["mode"] in ("int8", "bf16", "f32") and limits["limits"]
    assert cfg["source"] and isinstance(cfg["reduced"], list)
    if mix["loop"] != "encode":
        return
    assert {"embed_gap", "norm_gap", "wrong"} <= set(limits["limits"])
    assert 0 < limits["limits"]["embed_gap"] < 1
    model = cfg["model"]
    assert set(model) == {"reference", "encoder"} and model["encoder"]
    ref = check.model_reference(model)
    assert all(callable(getattr(ref, f)) for f in MODEL_FUNCTIONS)
    lengths, longest = mix["lengths"], ref.token_space(model)[1]
    assert lengths["dist"] in ("measured", "uniform", "lognormal")
    if lengths["dist"] == "measured":
        assert lengths["values"] and all(1 <= v <= longest for v in lengths["values"])
    else:
        assert 1 <= lengths["lo"] <= lengths["hi"] <= longest
    if "then" in mix:
        assert mix["then"]["entry"] == "dense_topk" and mix["then"]["k"] >= 10
        assert {"value_gap", "cut_gap"} <= set(limits["limits"])
        assert cfg["planted"] >= 10 and cfg["planted_noise"] > 0


def test_the_harness_names_no_configuration_mix_or_model():
    """What a later model or cell brings is found by name: the harness's
    code names none of them, nor a field of the port's encoder settings
    (but ``vocab_bits`` and ``dtype``, which are also the store's keys)."""
    names = {p.stem for d in ("configs", "traffic") for p in (harness.HERE / d).glob("*.json")}
    names |= {p.stem for p in (harness.HERE / "reference" / "models").glob("*.py")}
    names |= {"d_model", "n_layers", "n_heads", "d_ff", "max_len", "out_dim", "moe_experts"}
    for f in ("harness.py", "check.py", "system.py", "control.py"):
        text = (harness.HERE / f).read_text()
        assert not [n for n in names if n in text], f
