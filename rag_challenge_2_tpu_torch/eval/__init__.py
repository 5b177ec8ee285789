"""Analysis tools over a corpus index."""
