"""Company/year routing.

Port of ``rag_challenge_2_tpu/retrieval/routing.py``.  ``route_core`` is
the reference's numpy-generic routing core unchanged (the engine runs it
on host copies of the per-doc columns); :func:`route_mask` is the same
predicate over a :class:`CorpusIndex`'s row tensors.
"""

from __future__ import annotations

import re
from typing import List, Optional, Sequence

import torch

from ..index.schema import CorpusIndex

_YEAR_RE = re.compile(r"(20\d{2})年")


def extract_years_from_question(question: str, expand_window: bool = True) -> List[int]:
    """Years mentioned as ``20XX年``; optionally expanded to [min-1, max+1].

    "2024年…" with expansion → [2023, 2024, 2025]; range questions expand
    the whole span; no year → [].
    """
    years = [int(y) for y in _YEAR_RE.findall(question)]
    if not years:
        return []
    if expand_window:
        return list(range(min(years) - 1, max(years) + 2))
    return sorted(set(years))


def route_core(
    xp,
    valid,
    company_col,
    year_col,
    company_id: Optional[int] = None,
    years: Optional[Sequence[int]] = None,
    fallback: str = "all",
):
    """The routing semantics over numpy arrays (``xp`` = ``numpy``)."""
    base = valid
    if company_id is not None:
        # company_id = -1 means "unknown company": an empty mask.  None
        # means "no company filter".
        base = base & (company_col == company_id)

    if years:
        ymask = base & xp.isin(year_col, xp.asarray(list(years)))
        # fall back to all company docs when the year filter is empty
        return xp.where(xp.any(ymask), ymask, base)

    if fallback == "latest":
        latest = xp.max(xp.where(base, year_col, -1))
        lmask = base & (year_col == latest)
        return xp.where(latest >= 0, lmask, base)
    return base


def route_mask(
    index: CorpusIndex,
    company_id: Optional[int] = None,
    years: Optional[Sequence[int]] = None,
    fallback: str = "all",
) -> torch.Tensor:
    """Boolean row mask for (company, years) routing, on the index's device.

    Filter by company first; with ``years``, keep matching docs but fall
    back to the whole company when nothing matches; without years,
    ``fallback="all"`` keeps every company doc and ``"latest"`` only the
    newest year present.  Rows of unknown year (-1) join only the no-year
    fallback.
    """
    base = index.valid
    if company_id is not None:
        base = base & (index.company_id == company_id)
    if years:
        wanted = torch.as_tensor(list(years), dtype=index.year.dtype,
                                 device=index.year.device)
        ymask = base & torch.isin(index.year, wanted)
        return torch.where(ymask.any(), ymask, base)
    if fallback == "latest":
        latest = torch.where(base, index.year,
                             torch.full_like(index.year, -1)).max()
        return torch.where(latest >= 0, base & (index.year == latest), base)
    return base
