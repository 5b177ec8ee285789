"""The benchmark's plain reference.

Plain PyTorch and NumPy, written apart from the system under test and
importing nothing of it: year routing (``routing``), the BM25 tokenizer's
hashing and Okapi scoring over a CSR (``tokenize``, ``bm25``), int8, int4,
bf16 and f32 scoring of query vectors against store rows (``scoring``), and
max fusion with the query-hit and method bonuses (``fusion``).  The
benchmark hands the same generated inputs to the program and to these
functions; what the program derives from them (its int8 store, its term
ids, its hit lists) the reference works out again.
"""
