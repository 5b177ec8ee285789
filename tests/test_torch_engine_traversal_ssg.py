"""The engine's ``ssg`` method against the JAX engine: every tier and
option, wide k, bf16 / int8 stores and ``search_many``
(``tests/torch_engine_traversal_common.py`` has the bodies and the rules)."""

import pytest

from tests import torch_engine_traversal_common as common
from tests.torch_engine_traversal_common import (  # noqa: F401  (a fixture)
    OPTIONS, TIERS, drop_compiled_programs)


@pytest.mark.parametrize("option", list(OPTIONS))
@pytest.mark.parametrize("tier", TIERS)
@pytest.mark.parametrize("method", ["ssg"])
def test_traversal_search_matches_jax(tmp_path, rng, monkeypatch, method, tier, option):
    common.traversal_search_matches_jax(tmp_path, rng, monkeypatch, method, tier, option)


@pytest.mark.parametrize("route", ["plain", "wide"])
@pytest.mark.parametrize("method", ["ssg"])
def test_traversal_neighbor_k_100_matches_jax(tmp_path, rng, monkeypatch, method, route):
    common.traversal_neighbor_k_100_matches_jax(tmp_path, rng, monkeypatch, method, route)


@pytest.mark.parametrize("store", ["bfloat16", "int8"])
@pytest.mark.parametrize("tier", ["windowed", "window0"])
@pytest.mark.parametrize("method", ["ssg"])
def test_traversal_over_bf16_and_int8_stores(tmp_path, rng, monkeypatch, method,
                                             tier, store):
    common.traversal_over_bf16_and_int8_stores(tmp_path, rng, monkeypatch, method, tier, store)


@pytest.mark.parametrize("R", [1, 3, 5])
@pytest.mark.parametrize("tier", ["windowed", "window0"])
@pytest.mark.parametrize("method", ["ssg"])
def test_traversal_search_many_equals_searches_and_jax(tmp_path, rng, monkeypatch,
                                                       method, tier, R):
    common.traversal_search_many_equals_searches_and_jax(tmp_path, rng, monkeypatch, method, tier, R)
