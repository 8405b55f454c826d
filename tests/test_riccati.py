"""Riccati kernel correctness: sequential scan vs dense KKT ground truth vs
parallel associative scan (mirrors ocs2_ddp/test/CorrectnessTest.cpp, which
validates SLQ/iLQR against ocs2_qp_solver on random LQ problems)."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest

from lq_fixtures import random_lq_coeffs
from ocs2_tpu.ops import riccati
from ocs2_tpu.solvers.qp import solve_lq_dense

# Jitted entry points: eager op-by-op dispatch is slow on CPU and the
# persistent compilation cache makes repeated suite runs cheap.
lqr_backward = jax.jit(riccati.lqr_backward)
lqr_backward_parallel = jax.jit(riccati.lqr_backward_parallel)
lqr_forward = jax.jit(riccati.lqr_forward)


@pytest.mark.parametrize("seed,horizon,nx,nu", [(0, 8, 3, 2), (1, 20, 5, 3), (2, 31, 4, 1)])
def test_sequential_matches_dense_kkt(seed, horizon, nx, nu):
    key = jax.random.PRNGKey(seed)
    coeffs = random_lq_coeffs(key, horizon, nx, nu)
    dx0 = jax.random.normal(jax.random.PRNGKey(seed + 100), (nx,))

    sol = lqr_backward(coeffs)
    dxs, dus = lqr_forward(coeffs, sol, dx0)
    dense = solve_lq_dense(coeffs, dx0)

    assert np.allclose(dxs, dense.dxs, atol=2e-3), np.abs(dxs - dense.dxs).max()
    assert np.allclose(dus, dense.dus, atol=2e-3), np.abs(dus - dense.dus).max()


@pytest.mark.parametrize("seed,horizon,nx,nu", [(0, 16, 3, 2), (3, 64, 6, 4), (4, 33, 2, 2)])
def test_parallel_matches_sequential(seed, horizon, nx, nu):
    key = jax.random.PRNGKey(seed)
    coeffs = random_lq_coeffs(key, horizon, nx, nu)
    seq = lqr_backward(coeffs)
    par = lqr_backward_parallel(coeffs)

    assert np.allclose(par.value_S, seq.value_S, atol=5e-3), np.abs(
        par.value_S - seq.value_S
    ).max()
    assert np.allclose(par.value_s, seq.value_s, atol=5e-3), np.abs(
        par.value_s - seq.value_s
    ).max()
    assert np.allclose(par.gains, seq.gains, atol=5e-3)
    assert np.allclose(par.kff, seq.kff, atol=5e-3)


def test_value_function_predicts_cost():
    """V(dx0) = 1/2 dx0'S dx0 + s'dx0 + const must match the achieved QP cost
    difference between two initial states (checks cost-to-go extraction, the
    analogue of HpipmInterface::getRiccatiCostToGo)."""
    key = jax.random.PRNGKey(7)
    coeffs = random_lq_coeffs(key, 12, 3, 2, defect_scale=0.0)
    sol = lqr_backward(coeffs)

    def qp_cost(dx0):
        return float(solve_lq_dense(coeffs, dx0).cost)

    dx_a = jnp.array([0.3, -0.1, 0.2])
    dx_b = jnp.zeros(3)
    v = lambda dx: 0.5 * dx @ sol.value_S[0] @ dx + sol.value_s[0] @ dx
    predicted = float(v(dx_a) - v(dx_b))
    actual = qp_cost(dx_a) - qp_cost(dx_b)
    assert np.allclose(predicted, actual, atol=1e-2), (predicted, actual)


def test_batched_vmap_solve():
    """The kernel must vmap over problem instances (scenario batching)."""
    keys = jax.random.split(jax.random.PRNGKey(0), 8)
    batch = jax.vmap(lambda k: random_lq_coeffs(k, 10, 3, 2))(keys)
    sols = jax.vmap(lqr_backward)(batch)
    assert sols.gains.shape == (8, 10, 2, 3)
    single = lqr_backward(jax.tree.map(lambda x: x[3], batch))
    assert np.allclose(sols.gains[3], single.gains, atol=1e-5)


def test_regularization_shrinks_step():
    key = jax.random.PRNGKey(9)
    coeffs = random_lq_coeffs(key, 10, 3, 2)
    soft = lqr_backward(coeffs, reg=0.0)
    hard = lqr_backward(coeffs, reg=1e3)
    assert float(jnp.linalg.norm(hard.kff)) < float(jnp.linalg.norm(soft.kff))


class TestDenseStartSensitivity:
    """solvers/qp.py dense_start_sensitivity: the float64 ground truth that
    chip_smoke.py holds every batched Riccati path to."""

    @pytest.mark.parametrize("nx,nu,reg", [(4, 2, 0.0), (6, 3, 0.5)])
    def test_matches_riccati_node_zero(self, nx, nu, reg):
        from ocs2_tpu.solvers.qp import dense_start_sensitivity

        coeffs = random_lq_coeffs(jax.random.PRNGKey(nx), 7, nx=nx, nu=nu)
        sol = lqr_backward(coeffs, reg)
        shifted = coeffs._replace(Quu=coeffs.Quu + reg * jnp.eye(nu))
        dense = dense_start_sensitivity(shifted)
        for f in dense._fields:
            np.testing.assert_allclose(
                np.asarray(getattr(sol, f)[0]), getattr(dense, f),
                rtol=1e-4, atol=1e-5, err_msg=f,
            )


@pytest.mark.parametrize(
    "path", ["batch_minor", "vmap_single"], ids=["batch-minor", "vmap"]
)
@pytest.mark.parametrize(
    "nx,nu,horizon",
    [(10, 3, 8), (12, 4, 6), (24, 24, 4)],
    ids=["ballbot-widths", "quadrotor-widths", "legged-widths"],
)
def test_batched_paths_match_dense_kkt(path, nx, nu, horizon):
    """Both batched paths the vmap rule chooses between, at the widths of
    the batched solves, against the float64 dense KKT solve per scenario
    (regularization folded into Quu, as the Riccati recursion applies it)."""
    batch = 4
    keys = jax.random.split(jax.random.PRNGKey(nx + horizon), batch)
    coeffs = jax.vmap(lambda k: random_lq_coeffs(k, horizon, nx, nu))(keys)
    regs = jnp.asarray([0.0, 1e-6, 1e-2, 1.0])
    fn = {
        "batch_minor": riccati._lqr_backward_batched,
        "vmap_single": jax.vmap(riccati._lqr_backward_single),
    }[path]
    sols = jax.jit(fn)(coeffs, regs)
    dx0s = jax.random.normal(jax.random.PRNGKey(5), (batch, nx))
    for i in range(batch):
        one = jax.tree.map(lambda x: x[i], coeffs)
        sol = jax.tree.map(lambda x: x[i], sols)
        dxs, dus = lqr_forward(one, sol, dx0s[i])
        dense = solve_lq_dense(
            one._replace(Quu=one.Quu + regs[i] * jnp.eye(nu)), dx0s[i]
        )
        np.testing.assert_allclose(dxs, dense.dxs, atol=2e-3, err_msg=path)
        np.testing.assert_allclose(dus, dense.dus, atol=2e-3, err_msg=path)
