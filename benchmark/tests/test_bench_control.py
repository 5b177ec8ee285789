"""The check has to fail what is wrong: the control (one precision below
the configuration's) and the faults a cell can have, planted underneath
the timed path of a whole run at a tiny size on the CPU."""

import pytest
import torch

from benchmark import control

from .conftest import CELLS, PROOF, SEED, SERVED, UNLISTED, run_tiny, tiny


@pytest.mark.parametrize("cell", CELLS + UNLISTED)
def test_control_fails_and_program_passes(cell):
    cfg, mix, limits = tiny(cell)
    got, bad = control.readings(cell, SEED, torch.device("cpu"), cfg, mix, limits)
    lim = limits["limits"]
    assert all(got[n] <= lim[n] for n in lim), got
    assert any(bad[n] > lim[n] for n in lim), bad


# ------------------------------------------------------------ faults

def scan_fault(kind):
    import rag_challenge_2_tpu_torch.ops.topk as topk

    real = topk.dense_topk
    first = {}

    def broken(q, emb, k, *a, **kw):
        v, r = real(q, emb, k, *a, **kw)
        if kind == "altered":                  # one answer changed where produced
            r = r.clone()
            r[0, 0] = (r[0, 0] + 1) % emb.shape[0]
        elif kind == "half":                   # half the batch left out
            h = q.shape[0] // 2
            v, r = v.clone(), r.clone()
            v[h:2 * h], r[h:2 * h] = v[:h], r[:h]
        elif kind == "stale":                  # the state returned unchanged
            first.setdefault("out", (v, r))
            v, r = first["out"]
        return v, r
    return topk, "dense_topk", broken


def served_fault(kind):
    import rag_challenge_2_tpu_torch.retrieval.engine as engine

    if kind == "altered":                      # one key changed where produced
        real = engine.fuse_hits

        def broken(*a, **kw):
            out = real(*a, **kw)
            out.key = out.key.clone()
            out.key[3] = out.key[3] + 1
            return out
        return engine, "fuse_hits", broken
    if kind == "arm_left_out":                 # the BM25 arm's hits dropped
        real = engine.bm25_hits

        def broken(*a, **kw):
            rows, sims, qids, mids, ok = real(*a, **kw)
            return rows, sims, qids, mids, torch.zeros_like(ok)
        return engine, "bm25_hits", broken
    if kind == "half":                         # half of a request's queries left out
        real = engine.dense_hits

        def broken(index, req, *a, **kw):
            rows, sims, qids, mids, ok = real(index, req, *a, **kw)
            half = qids >= req.q.shape[0] // 2
            return rows, sims, qids, mids, ok & ~half
        return engine, "dense_hits", broken
    real = engine.QueryEngine.search           # the first answer returned ever after
    first = {}

    def broken(self, *a, **kw):
        return first.setdefault("out", real(self, *a, **kw))
    return engine.QueryEngine, "search", broken


@pytest.mark.parametrize("kind", ["altered", "half", "stale"])
@pytest.mark.parametrize("cell", CELLS)
def test_scan_faults_fail(cell, kind, monkeypatch):
    owner, attr, broken = scan_fault(kind)
    monkeypatch.setattr(owner, attr, broken)
    assert run_tiny(cell)["correct"] is False


@pytest.mark.parametrize("kind", ["altered", "arm_left_out", "half", "stale"])
@pytest.mark.parametrize("cell", SERVED)
def test_served_faults_fail(cell, kind, monkeypatch):
    owner, attr, broken = served_fault(kind)
    monkeypatch.setattr(owner, attr, broken)
    assert run_tiny(cell)["correct"] is False


def encode_fault(kind):
    import rag_challenge_2_tpu_torch.models.encoder as encoder

    if kind == "block_skipped":                # the second block returns its input
        real = encoder.Encoder.__init__

        def broken(self, *a, **kw):
            real(self, *a, **kw)
            self.blocks[1].forward = lambda x, mask, plan=None: (x, None)
        return encoder.Encoder, "__init__", broken
    if kind == "fp8":                          # the projections' inputs rounded to fp8
        real = encoder._dense

        def broken(x, lin, dtype):
            w = torch.nn.Linear(lin.in_features, lin.out_features)
            with torch.no_grad():
                w.weight.copy_(control.fp8_e4m3(lin.weight))
                w.bias.copy_(lin.bias)
            return real(control.fp8_e4m3(x.float()), w, dtype)
        return encoder, "_dense", broken
    real = encoder.EmbeddingModel.embed_tokens
    last = {}

    def broken(self, ids):
        e = real(self, ids)
        if kind == "moved":                    # every value moved by 1e-3 where produced
            return e + 1e-3
        if kind == "half":                     # half the batch left out
            h = e.shape[0] // 2
            e = e.clone()
            e[h:2 * h] = e[:h]
            return e
        # stale: the previous call's batch (a window of one request, as a
        # loaded host may run, still gets one: the warm-up's last)
        out = last.get("out", e)
        last["out"] = e
        return out
    return encoder.EmbeddingModel, "embed_tokens", broken


@pytest.mark.parametrize("kind", ["block_skipped", "moved", "fp8", "half", "stale"])
@pytest.mark.parametrize("cell", PROOF)
def test_encode_faults_fail(cell, kind, monkeypatch):
    owner, attr, broken = encode_fault(kind)
    monkeypatch.setattr(owner, attr, broken)
    assert run_tiny(cell)["correct"] is False
