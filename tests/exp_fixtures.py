"""EXP0 / EXP1 switched-system fixtures with known optimal costs.

Re-expressions of the reference's canonical switched-problem anchors
(ocs2_oc/test/include/ocs2_oc/test/EXP0.h:46-176, EXP1.h:44-230; expected
optimal costs from ocs2_ddp/test/Exp0Test.cpp:49 (9.766) and
Exp1Test.cpp:49 (5.4399)).  Mode-switched dynamics are expressed the
JAX-native way: stacked per-mode matrices / lax.switch indexed by the
per-node mode injected through params (oc/approx.node_params), instead of
virtual dispatch through a ReferenceManager.
"""
import jax.numpy as jnp
import numpy as np
from jax import lax

from ocs2_tpu.core.reference import TargetTrajectories
from ocs2_tpu.oc.problem import (
    OptimalControlProblem,
    quadratic_cost,
    quadratic_final_cost,
)
from ocs2_tpu.oc.time_discretization import make_time_grid

# -- EXP0: 2 linear modes, one switch, expected optimal cost 9.766 ----------
EXP0_EVENT_TIMES = (0.1897,)
EXP0_MODE_SEQUENCE = (0, 1)
EXP0_X0 = jnp.array([0.0, 2.0])
EXP0_T0, EXP0_TF = 0.0, 2.0
EXP0_EXPECTED_COST = 9.766

# numpy constants: they bake into the compiled program as literals.
_EXP0_A = np.stack(
    [
        np.array([[0.6, 1.2], [-0.8, 3.4]], np.float32),
        np.array([[4.0, 3.0], [-1.0, 0.0]], np.float32),
    ]
)
_EXP0_B = np.stack(
    [np.array([[1.0], [1.0]], np.float32), np.array([[2.0], [-1.0]], np.float32)]
)


def exp0_problem() -> OptimalControlProblem:
    def dynamics(t, x, u, p):
        a = jnp.asarray(_EXP0_A)[p["mode"]]
        b = jnp.asarray(_EXP0_B)[p["mode"]]
        return a @ x + b @ u

    return OptimalControlProblem(
        dynamics=dynamics,
        cost_terms=(quadratic_cost(jnp.diag(jnp.array([0.0, 1.0])), jnp.eye(1)),),
        final_cost_terms=(quadratic_final_cost(jnp.eye(2)),),
        nx=2,
        nu=1,
    )


def exp0_params() -> dict:
    return {
        "target": TargetTrajectories.constant(
            jnp.array([4.0, 2.0]), jnp.zeros(1)
        )
    }


def exp0_grid(num_intervals: int = 100):
    return make_time_grid(
        EXP0_T0, EXP0_TF, num_intervals,
        event_times=EXP0_EVENT_TIMES, mode_sequence=EXP0_MODE_SEQUENCE,
    )


# -- EXP1: 3 nonlinear modes, two switches, expected optimal cost 5.4399 ----
EXP1_EVENT_TIMES = (0.2262, 1.0176)
EXP1_MODE_SEQUENCE = (0, 1, 2)
EXP1_X0 = jnp.array([2.0, 3.0])
EXP1_T0, EXP1_TF = 0.0, 3.0
EXP1_EXPECTED_COST = 5.4399


def exp1_problem() -> OptimalControlProblem:
    def f0(x, u):
        return jnp.array(
            [x[0] + u[0] * jnp.sin(x[0]), -x[1] - u[0] * jnp.cos(x[1])]
        )

    def f1(x, u):
        return jnp.array(
            [x[1] + u[0] * jnp.sin(x[1]), -x[0] - u[0] * jnp.cos(x[0])]
        )

    def f2(x, u):
        return jnp.array(
            [-x[0] - u[0] * jnp.sin(x[0]), x[1] + u[0] * jnp.cos(x[1])]
        )

    def dynamics(t, x, u, p):
        return lax.switch(p["mode"], [f0, f1, f2], x, u)

    return OptimalControlProblem(
        dynamics=dynamics,
        cost_terms=(quadratic_cost(jnp.eye(2), jnp.eye(1)),),
        final_cost_terms=(quadratic_final_cost(jnp.eye(2)),),
        nx=2,
        nu=1,
    )


def exp1_params() -> dict:
    return {
        "target": TargetTrajectories.constant(
            jnp.array([1.0, -1.0]), jnp.zeros(1)
        )
    }


def exp1_grid(num_intervals: int = 150):
    return make_time_grid(
        EXP1_T0, EXP1_TF, num_intervals,
        event_times=EXP1_EVENT_TIMES, mode_sequence=EXP1_MODE_SEQUENCE,
    )
