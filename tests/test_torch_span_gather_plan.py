"""The planner of kernel K2 (``ops/span_gather.plan``) on the CPU.

The kernel takes its cut of the spans into (span, piece) work items, one
block each, and the 16-byte chunks a thread holds from the planner, so
these tests hold the planner to what the kernel needs: every span's
``[0, window)`` covered exactly once, no more blocks than work items, every
output chunk of a piece owned by a thread.  A model of the kernel's
per-item arithmetic (the 16-byte-aligned source chunks each thread loads,
the realigned 16-byte writes, the clamped word path at the array's ends)
is run here on numpy against the plain gather, so the index arithmetic is
checked without the card; the card tests hold the kernel itself bitwise.
"""

import numpy as np
import pytest
import torch

from rag_challenge_2_tpu_torch.ops import span_gather as sg

WINDOWS = [1, 3, 4, 5, 512, 577, 4096, 10_000]


def work_items(cut, window):
    """``(block, span, first word, words)`` of every work item, as the
    kernel maps them: block ``span * n_pieces + piece`` copies words
    ``[piece * cut.piece, ...)`` of its span."""
    out = []
    for i in range(cut.items):
        span, pc = divmod(i, cut.n_pieces)
        first = pc * cut.piece
        out.append((i, span, first, min(cut.piece, window - first)))
    return out


@pytest.mark.parametrize("n_arrays", [2, 3])
@pytest.mark.parametrize("G", [1, 7, 529, 1016])
@pytest.mark.parametrize("window", WINDOWS)
def test_work_items_cover_every_span_once(window, G, n_arrays):
    cut = sg.plan(G, window, n_arrays)
    items = work_items(cut, window)
    assert len(items) == cut.items == G * cut.n_pieces
    assert [b for b, *_ in items] == list(range(cut.items))   # one block an item
    per_span = {}
    for _, span, first, words in items:
        assert 0 <= span < G and 1 <= words <= cut.piece
        per_span.setdefault(span, []).append((first, words))
    assert sorted(per_span) == list(range(G))
    for pieces in per_span.values():
        covered = np.zeros(window, dtype=np.int64)
        for first, words in pieces:
            covered[first:first + words] += 1
        assert (covered == 1).all()


@pytest.mark.parametrize("n_arrays", [2, 3])
@pytest.mark.parametrize("window", WINDOWS + [2048, 2049, 4097, 100_000])
def test_pieces_and_the_chunks_a_thread_holds(window, n_arrays):
    for G in (1, 2, 511, 512, 1016, 100_000):
        cut = sg.plan(G, window, n_arrays)
        assert cut.items == G * cut.n_pieces < 2 ** 31                  # grid.x
        assert cut.piece <= sg.MAX_PIECE
        assert (cut.n_pieces - 1) * cut.piece < window <= cut.n_pieces * cut.piece
        if cut.n_pieces > 1:
            # pieces of an aligned row start aligned
            assert cut.piece % 4 == 0
        # every 16-byte chunk of a piece has a thread, with the fewest chunks
        # a thread can hold (fewer registers, more blocks an SM)
        piece_chunks = -(-cut.piece // 4)
        assert cut.chunks in (1, 2, sg.MAX_CHUNKS)
        assert piece_chunks <= cut.chunks * sg.THREADS
        smaller = [c for c in (1, 2, sg.MAX_CHUNKS) if c < cut.chunks]
        assert all(piece_chunks > c * sg.THREADS for c in smaller)


@pytest.mark.parametrize("G,window,n_arrays,expect", [
    (512, 512, 3, (512, 1, 512, 1)),       # the capped CSR of the 1.5M witness
    (512, 4096, 3, (2048, 2, 1024, 4)),    # the deployment's BM25 window (the cap)
    (1016, 600, 2, (600, 1, 1016, 2)),     # the IVF arm, 127 queries x nprobe 8
])
def test_main_path_shapes(G, window, n_arrays, expect):
    """The main path's geometry: (piece, pieces, blocks, chunks a thread
    holds)."""
    cut = sg.plan(G, window, n_arrays)
    assert (cut.piece, cut.n_pieces, cut.items, cut.chunks) == expect


@pytest.mark.parametrize("bad", [(0, 8, 2), (4, 0, 2), (4, 8, 1), (4, 8, 4), (4, 8, 0)])
def test_plan_rejects_what_the_kernel_does_not_take(bad):
    G, window, n_arrays = bad
    with pytest.raises(ValueError):
        sg.plan(G, window, n_arrays)


def _kernel_model(arrays, offsets, n, starts, window, cut):
    """The kernel's arithmetic on numpy: ``arrays[a]`` is a flat buffer and
    ``offsets[a]`` the word address at which the gathered view of ``n``
    words starts, so the 16-byte residue of a position is
    ``(offset + p) & 3``."""
    G = starts.shape[0]
    out = np.full((len(arrays), G, window), -7, dtype=np.int64)
    for _, span, first, words in work_items(cut, window):
        p0 = int(starts[span]) + first
        end = p0 + words
        # the aligned extension of the piece in each array
        ext = [(p0 - ((off + p0) & 3), end + ((-(off + end)) & 3)) for off in offsets]
        edge = any(lo < 0 or hi > n for lo, hi in ext)
        for a, (buf, off) in enumerate(zip(arrays, offsets)):
            row = out[a, span, first:first + words]
            if edge:                                  # the word path
                row[:] = buf[off + np.clip(np.arange(p0, end), 0, n - 1)]
                continue
            lo, hi = ext[a]
            mis = p0 - lo
            # the wrapper's one [n_arrays, G, window] buffer starts 16-byte aligned
            dst_word = (a * G + span) * window + first
            head = min(words, (4 - (dst_word & 3)) & 3)
            nb = (words - head) // 4
            assert nb <= cut.chunks * sg.THREADS
            sh = mis + head
            base, r = sh >> 2, sh & 3

            def chunk(q):
                # an aligned 16-byte source chunk, inside the extension
                assert lo + 4 * q >= lo and lo + 4 * q + 4 <= hi
                return buf[off + lo + 4 * q:off + lo + 4 * q + 4]

            row[:head] = buf[off + p0:off + p0 + head]
            for c in range(nb):
                lo4 = chunk(base + c)
                hi4 = chunk(base + c + 1) if r else lo4
                row[head + 4 * c:head + 4 * c + 4] = np.concatenate([lo4, hi4])[r:r + 4]
            tail = head + 4 * nb
            row[tail:] = buf[off + p0 + tail:off + end]
    return out


@pytest.mark.parametrize("window", WINDOWS)
def test_kernel_model_equals_plain_gather(window):
    """Every start residue, views at +0 / +1 / +3 words, spans crossing
    both ends of a CSR without slack."""
    rng = np.random.default_rng(window)
    n = 3 * window + 4100
    base = rng.integers(0, 1 << 30, size=n + 3)
    for view in (0, 1, 3):
        arrays = [base, base[::-1].copy()]
        offsets = [view, 3 - view]
        for r in range(4):
            inner = rng.integers(0, n - window, size=9)
            starts = np.concatenate([inner - inner % 4 + r,
                                     [-window - 2, -1, 0, n - window, n - 1, n + 5]])
            starts = starts.astype(np.int64)
            cut = sg.plan(starts.shape[0], window, 2)
            got = _kernel_model(arrays, offsets, n, starts, window, cut)
            views = [torch.from_numpy(a[o:o + n]) for a, o in zip(arrays, offsets)]
            ref = sg.gather_posting_spans_plain(
                views[0], views[1], torch.from_numpy(starts).to(torch.int32), window=window)
            for a in range(2):
                assert np.array_equal(got[a], ref[a].numpy())
