"""prof/riccati_triton.py, the unused Pallas/Triton Riccati kernel kept as the
starting point of a Hopper kernel: in the Pallas interpreter it must still
match the XLA batch-minor path, including a batch that pads to whole blocks."""
import os
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest

import bench
from ocs2_tpu.ops.riccati import _lqr_backward_batched

sys.path.insert(
    0, os.path.join(os.path.dirname(os.path.dirname(os.path.abspath(__file__))), "prof")
)
from riccati_triton import BLOCK_BATCH, lqr_backward_pallas, padded_batch  # noqa: E402


@pytest.mark.parametrize(
    "batch,n,nx,nu", [(40, 5, 5, 3), (8, 3, 4, 2)], ids=["padded-40", "one-block"]
)
def test_interpret_matches_batch_minor(batch, n, nx, nu):
    coeffs = bench.random_lq_batch(jax.random.PRNGKey(batch), batch, n, nx, nu)
    reg = jnp.linspace(0.0, 0.5, batch)
    out = lqr_backward_pallas(coeffs, reg, interpret=True)
    ref = _lqr_backward_batched(coeffs, reg)
    for f in ref._fields:
        a, b = np.asarray(getattr(out, f)), np.asarray(getattr(ref, f))
        assert a.shape == b.shape, f
        assert np.max(np.abs(a - b)) <= 1e-5 * np.max(np.abs(b)), f


def test_padded_batch_rounds_up_to_blocks():
    assert padded_batch(BLOCK_BATCH, BLOCK_BATCH) == BLOCK_BATCH
    assert padded_batch(BLOCK_BATCH + 1, BLOCK_BATCH) == 2 * BLOCK_BATCH
    assert padded_batch(1, BLOCK_BATCH) == BLOCK_BATCH
