"""Company and year routing over a list of documents.

A question for ``company`` and ``years`` searches that company's documents
of those years; when none of its documents has one of the years, all of
its documents.  More than ``max_docs`` documents keep the newest (by year,
then document id).  Documents come back in ascending id order.
"""

from __future__ import annotations

from typing import List, Optional, Sequence


def routed_docs(docs: Sequence[dict], company: str,
                years: Optional[Sequence[int]], max_docs: int) -> List[int]:
    """``docs``: one dict a document with ``company`` and ``year``."""
    own = [i for i, d in enumerate(docs) if d["company"] == company]
    picked = own
    if years:
        wanted = set(int(y) for y in years)
        by_year = [i for i in own if docs[i]["year"] in wanted]
        picked = by_year or own
    if len(picked) > max_docs:
        newest = sorted(picked, key=lambda i: (docs[i]["year"], i), reverse=True)
        picked = newest[:max_docs]
    return sorted(picked)
