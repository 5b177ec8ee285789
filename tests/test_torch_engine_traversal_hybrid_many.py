"""The engine's ``hybrid_expansion`` method against the JAX engine over
bf16 / int8 stores and through ``search_many``
(``tests/torch_engine_traversal_common.py`` has the shared bodies)."""

import pytest

from tests import torch_engine_traversal_common as common
from tests.torch_engine_traversal_common import drop_compiled_programs  # noqa: F401


@pytest.mark.parametrize("store", ["bfloat16", "int8"])
@pytest.mark.parametrize("tier", ["windowed", "window0"])
@pytest.mark.parametrize("method", ["hybrid_expansion"])
def test_traversal_over_bf16_and_int8_stores(tmp_path, rng, monkeypatch, method,
                                             tier, store):
    common.traversal_over_bf16_and_int8_stores(tmp_path, rng, monkeypatch, method, tier, store)


@pytest.mark.parametrize("R", [1, 3, 5])
@pytest.mark.parametrize("tier", ["windowed", "window0"])
@pytest.mark.parametrize("method", ["hybrid_expansion"])
def test_traversal_search_many_equals_searches_and_jax(tmp_path, rng, monkeypatch,
                                                       method, tier, R):
    common.traversal_search_many_equals_searches_and_jax(tmp_path, rng, monkeypatch, method, tier, R)
