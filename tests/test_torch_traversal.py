"""Graph traversal (``retrieval/traversal.py``) against the JAX package's
on the same numpy inputs, on the CPU (plain hops on both sides).

Tolerances: ``hop_score``, ``cand_scores`` and emitted sims within 1e-5 on
f32 / bf16 stores and 1e-4 on int8 stores.  A path is a chain of discrete
choices, so paths, ``valid`` and ``cand_ids`` are compared for the anchors
whose choices are clear of ties: the best two step scores of every hop,
and consecutive hop scores (SSG's strict-improvement bar), apart by more
than 2e-5 (both sides dequantize an int8 store the same way, so its ties
are no wider than an f32 store's).  The anchors left out are counted and
may be at most 1% of all."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from rag_challenge_2_tpu.ops.quant import quantize_rows as jax_quantize_rows
from rag_challenge_2_tpu.retrieval import traversal as jtv
from rag_challenge_2_tpu_torch.retrieval import traversal as ttv

STORES = ("float32", "bfloat16", "int8")
TIE_TOL = 1e-5
MODES = ("ssg", "triangulation")
# seeds whose data has no tied choice in any store type
SEED_FULL, SEED_WINDOWED = 20, 23


def tol_of(store):
    return 1e-4 if store == "int8" else 1e-5


def unit(rng, n, d):
    x = rng.normal(size=(n, d)).astype(np.float32)
    return x / np.linalg.norm(x, axis=-1, keepdims=True)


def make_store(emb, store):
    """The same rows as a JAX array and a tensor (+ row scales for int8)."""
    if store == "int8":
        e8, sc = jax_quantize_rows(jnp.asarray(emb))
        return (e8, sc), (torch.from_numpy(np.array(e8)),
                          torch.from_numpy(np.array(sc)))
    if store == "bfloat16":
        ej = jnp.asarray(emb).astype(jnp.bfloat16)
        et = torch.from_numpy(np.array(ej.astype(jnp.float32))).to(torch.bfloat16)
        return (ej, None), (et, None)
    return (jnp.asarray(emb), None), (torch.from_numpy(emb), None)


def clear_anchors(jres, ssg, tol=TIE_TOL):
    """Anchors whose every discrete choice is apart by more than 2 tol."""
    cs = np.asarray(jres.cand_scores)
    ci = np.asarray(jres.cand_ids)
    hs = np.asarray(jres.hop_score)
    path = np.asarray(jres.path)
    ok = np.ones(path.shape[0], bool)
    if cs.shape[2] > 1:
        two = ci[:, :, 1] >= 0
        ok &= ~(two & (np.abs(cs[:, :, 0] - cs[:, :, 1]) <= 2 * tol)).any(1)
    stepped = (path[:, 2:] >= 0) & ssg           # the bar is SSG's alone
    ok &= ~(stepped & (np.abs(hs[:, 2:] - hs[:, 1:-1]) <= 2 * tol)).any(1)
    return ok


def assert_same_traversal(tres, jres, tol, where=""):
    ok = clear_anchors(jres, "ssg" in where)
    left_out = int((~ok).sum())
    print(f"{where}: {left_out} of {ok.size} anchors left out as tied")
    assert left_out <= 0.01 * ok.size
    for name in ("path", "valid", "cand_ids"):
        np.testing.assert_array_equal(
            getattr(tres, name).numpy()[ok], np.asarray(getattr(jres, name))[ok],
            err_msg=f"{where} {name}")
    for name in ("hop_score", "cand_scores"):
        np.testing.assert_allclose(
            getattr(tres, name).numpy()[ok], np.asarray(getattr(jres, name))[ok],
            rtol=tol, atol=tol, err_msg=f"{where} {name}")
    assert tres.path.dtype == torch.int32 and tres.cand_ids.dtype == torch.int32


def both_traverse(emb, anchors, q, mask, store, **kw):
    (ej, sj), (et, st) = make_store(emb, store)
    jres = jtv.traverse(ej, jnp.asarray(anchors), jnp.asarray(q),
                        jnp.asarray(mask), sj, **kw)
    tres = ttv.traverse(et, torch.from_numpy(anchors), torch.from_numpy(q),
                        torch.from_numpy(mask), st, **kw)
    return tres, jres


@pytest.mark.parametrize("store", STORES)
@pytest.mark.parametrize("mode", MODES)
@pytest.mark.parametrize("mask_kind", ["shared", "per_anchor"])
def test_traverse_matches_jax(mode, store, mask_kind):
    rng = np.random.default_rng(SEED_FULL)
    N, D, A = 240, 32, 12
    emb = unit(rng, N, D)
    anchors = rng.integers(0, N, size=A).astype(np.int32)
    anchors[3] = -1                                   # an inactive anchor
    q = unit(rng, A, D)
    if mask_kind == "shared":
        mask = rng.random(N) > 0.2
    else:
        mask = np.zeros((A, N), bool)
        for a in range(A):
            mask[a, (a % 3) * 80 : (a % 3 + 1) * 80] = True
    if mask.ndim == 1:
        mask[anchors[anchors >= 0]] = True
    tres, jres = both_traverse(emb, anchors, q, mask, store, max_hops=4,
                               neighbor_k=8, mode=mode)
    assert_same_traversal(tres, jres, tol_of(store), f"{mode} {store} {mask_kind}")
    assert not tres.valid[3].any() and tres.valid[0, 0]
    assert (tres.path[:, 1:] >= 0).any()              # walks do step


@pytest.mark.parametrize("mode", MODES)
def test_traverse_fewer_eligible_rows_than_candidates(mode):
    """A mask with 5 eligible rows and neighbor_k + 1 = 9 candidates: the
    masked rows past them come at NEG_INF and are never stepped to."""
    rng = np.random.default_rng(9)
    emb = unit(rng, 60, 16)
    mask = np.zeros(60, bool)
    mask[[4, 9, 30, 31, 55]] = True
    anchors = np.array([4, 30], np.int32)
    tres, jres = both_traverse(emb, anchors, unit(rng, 2, 16), mask, "float32",
                               max_hops=6, neighbor_k=8, mode=mode)
    assert_same_traversal(tres, jres, 1e-5, mode)
    p = tres.path.numpy()
    assert set(p[p >= 0].tolist()) <= {4, 9, 30, 31, 55}
    if mode == "triangulation":                        # never stops early
        assert (p[:, :5] >= 0).all() and (p[:, 5:] < 0).all()


def test_neighbor_k_above_the_kernels_k_on_the_cpu():
    """neighbor_k + 1 = 71 candidates: the plain hops take any k."""
    rng = np.random.default_rng(2)
    emb = unit(rng, 150, 16)
    anchors = np.array([1, 77, 149], np.int32)
    tres, jres = both_traverse(emb, anchors, unit(rng, 3, 16), np.ones(150, bool),
                               "float32", max_hops=3, neighbor_k=70, mode="ssg")
    assert_same_traversal(tres, jres, 1e-5, "ssg k=71")


def windowed_case(rng, store):
    """4 documents of 40, 5 (shorter than neighbor_k + 1 = 9), 40 and 33
    rows; the last one ends at the corpus tail; trailing rows of no
    document lie between the third and the fourth."""
    D, A = 32, 6
    win_start = np.array([0, 40, 45, 90], np.int32)
    win_len = np.array([40, 5, 40, 33], np.int32)
    N = 123
    emb = unit(rng, N, D)
    anchors = np.stack([rng.integers(s, s + l, size=A)
                        for s, l in zip(win_start, win_len)]).astype(np.int32)
    anchors[2, 4] = -1
    anchors[3, 0] = N - 1                              # the corpus' last row
    q = unit(rng, 4 * A, D).reshape(4, A, D)
    return emb, anchors, q, win_start, win_len


@pytest.mark.parametrize("store", STORES)
@pytest.mark.parametrize("mode", MODES)
@pytest.mark.parametrize("approx_rt", [None, 0.95])
def test_traverse_windowed_matches_jax(mode, store, approx_rt):
    rng = np.random.default_rng(SEED_WINDOWED)
    emb, anchors, q, ws, wl = windowed_case(rng, store)
    (ej, sj), (et, st) = make_store(emb, store)
    kw = dict(window=64, max_hops=4, neighbor_k=8, mode=mode)
    jres = jtv.traverse_windowed(ej, jnp.asarray(anchors), jnp.asarray(q),
                                 jnp.asarray(ws), jnp.asarray(wl), sj, **kw)
    tres = ttv.traverse_windowed(et, torch.from_numpy(anchors), torch.from_numpy(q),
                                 ws, wl, st, approx_rt=approx_rt, **kw)
    assert_same_traversal(tres, jres, tol_of(store), f"windowed {mode} {store}")
    p = tres.path.reshape(4, -1, 5).numpy()
    for g in range(4):                                 # walks stay in their document
        rows = p[g][p[g] >= 0]
        assert ((rows >= ws[g]) & (rows < ws[g] + wl[g])).all()
    assert (p[1][:, 1:] >= 0).sum() > 0                # the 5-row document is walked
    assert p[3, 0, 0] == 122 and p[3, 0, 1] >= 90      # from the corpus' last row
    # tensors for the row ranges give the same result as host sequences
    again = ttv.traverse_windowed(
        et, torch.from_numpy(anchors), torch.from_numpy(q),
        torch.from_numpy(ws), torch.from_numpy(wl), st, **kw)
    for a, b in zip(tres, again):
        assert torch.equal(a, b)


@pytest.mark.parametrize("store", STORES)
@pytest.mark.parametrize("mode", MODES)
def test_windowed_equals_masked_traverse(mode, store):
    """The port's own two forms agree: per-document views against the
    whole store under [G*A, N] document masks."""
    rng = np.random.default_rng(13)
    emb, anchors, q, ws, wl = windowed_case(rng, store)
    _, (et, st) = make_store(emb, store)
    kw = dict(max_hops=4, neighbor_k=8, mode=mode)
    win = ttv.traverse_windowed(et, torch.from_numpy(anchors), torch.from_numpy(q),
                                ws, wl, st, **kw)
    G, A = anchors.shape
    mask = np.zeros((G * A, emb.shape[0]), bool)
    for g in range(G):
        mask[g * A : (g + 1) * A, ws[g] : ws[g] + wl[g]] = True
    full = ttv.traverse(et, torch.from_numpy(anchors.reshape(-1)),
                        torch.from_numpy(q.reshape(G * A, -1)),
                        torch.from_numpy(mask), st, **kw)
    assert torch.equal(win.path, full.path)
    assert torch.equal(win.cand_ids, full.cand_ids)
    torch.testing.assert_close(win.hop_score, full.hop_score, rtol=1e-5, atol=1e-6)
    torch.testing.assert_close(win.cand_scores, full.cand_scores, rtol=1e-5, atol=1e-6)


@pytest.mark.parametrize("store", ["int8", "float32"])
def test_plain_hop_blocks_carry_the_topk(store, monkeypatch):
    """The plain hop in blocks of 16 rows equals the one-shot hop, with
    ties (every row stored three times) going to the lowest row."""
    rng = np.random.default_rng(3)
    base = unit(rng, 50, 16)
    emb = np.concatenate([base, base, base])
    _, (et, st) = make_store(emb, store)
    lhs = torch.from_numpy(unit(rng, 7, 16))
    mask = torch.from_numpy(rng.random((7, 150)) > 0.3)
    one_v, one_i = ttv._plain_hop(lhs, et, st, mask, 9)
    monkeypatch.setattr(ttv, "HOP_BLOCK_ROWS", 16)
    blk_v, blk_i = ttv._plain_hop(lhs, et, st, mask, 9)
    assert torch.equal(one_i, blk_i)
    torch.testing.assert_close(one_v, blk_v, rtol=0, atol=1e-6)
    s = lhs @ et.float().T
    if st is not None:
        s = s * st[None, :]
    s = torch.where(mask, s, torch.full_like(s, ttv.NEG_INF))
    ref_v, ref_i = torch.sort(s, dim=1, descending=True, stable=True)
    assert torch.equal(blk_i.long(), ref_i[:, :9])


def test_int8_hop_does_not_quantize_the_walker():
    """An int8 hop scores the f32 walker vector against dequantized rows:
    the hop's values equal that product, not the int8 x int8 one."""
    rng = np.random.default_rng(4)
    emb = unit(rng, 90, 32)
    _, (e8, sc) = make_store(emb, "int8")
    cur = torch.from_numpy(unit(rng, 3, 32))
    path = torch.full((3, 2), -1, dtype=torch.int32)
    vals, ids, _, _, _ = ttv._hop_candidates(cur, e8, sc, None, path, 5)
    want = (cur @ (e8.float() * sc[:, None]).T).gather(1, ids.long())
    torch.testing.assert_close(vals, want, rtol=1e-6, atol=1e-6)


@pytest.mark.parametrize("store", STORES)
def test_emit_hits_matches_jax(store):
    rng = np.random.default_rng(6)
    emb = unit(rng, 80, 32)
    anchors = np.array([10, -1, 44], np.int32)
    q = unit(rng, 3, 32)
    tres, jres = both_traverse(emb, anchors, q, np.ones(80, bool), store,
                               max_hops=3, neighbor_k=6, mode="triangulation")
    assert_same_traversal(tres, jres, tol_of(store), f"emit triangulation {store}")
    (ej, sj), (et, st) = make_store(emb, store)
    jr, js = jtv.emit_hits(ej, jnp.asarray(q), jres, sj)
    tr, ts = ttv.emit_hits(et, torch.from_numpy(q), tres, st)
    np.testing.assert_array_equal(tr.numpy(), np.asarray(jr))
    np.testing.assert_allclose(ts.numpy(), np.asarray(js), rtol=tol_of(store),
                               atol=tol_of(store))
    deq = et.float() if st is None else et.float() * st[:, None]
    for j in range(tr.shape[1]):
        if tr[0, j] >= 0:
            np.testing.assert_allclose(ts[0, j], q[0] @ deq[tr[0, j]].numpy(),
                                       rtol=1e-5, atol=1e-6)
    assert (ts[1] == 0).all() and (tr[1] == -1).all()


def test_first_hop_is_exempt_from_the_early_stop():
    """SSG's bar starts at NEG_INF: the first hop steps although no
    neighbour beats the anchor's self-similarity of 1."""
    rng = np.random.default_rng(8)
    emb = unit(rng, 40, 16)
    res = ttv.traverse(torch.from_numpy(emb), torch.tensor([7]),
                       torch.from_numpy(emb[7:8]), torch.ones(40, dtype=torch.bool),
                       max_hops=2, neighbor_k=5, mode="ssg")
    assert res.path[0, 1] >= 0 and res.hop_score[0, 1] < 1.0
    assert res.hop_score[0, 0] == 1.0


def test_empty_inputs():
    emb = torch.zeros((0, 8))
    res = ttv.traverse(emb, torch.tensor([0, -1]), torch.zeros((2, 8)), None,
                       max_hops=2, neighbor_k=3, mode="ssg")
    assert (res.path == -1).all() and res.cand_ids.shape == (2, 2, 4)
    res = ttv.traverse_windowed(torch.ones((6, 8)), torch.tensor([[2, 4]]),
                                torch.zeros((1, 2, 8)), [0], [0],
                                max_hops=2, neighbor_k=3, mode="triangulation")
    assert (res.path == -1).all() and not res.valid.any()
