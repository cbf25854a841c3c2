"""The serving slice of the port against the JAX package's under the
collator layouts test_torch_port_slice.py does not run: dedup tables
without packing, dense grids without fusion or compaction, and candidate
rows wider than max_position_embeddings (the chunked encoder loop).
Scores within 1e-5 abs; answers and idx equal."""

import pytest
import torch

from test_torch_port_slice import check_predict_matches_jax, flax_params  # noqa: F401

torch.set_num_threads(2)


@pytest.mark.parametrize("layout", ["dedup-only", "dense-unfused", "chunked"])
def test_predict_matches_jax(layout, flax_params):  # noqa: F811
    check_predict_matches_jax(layout, flax_params)
