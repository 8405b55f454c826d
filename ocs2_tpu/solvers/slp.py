"""Sequential linear programming solver (SLP) with the PIPG inner solver.

JAX-native re-design of the reference SLP solver (ocs2_slp/include/ocs2_slp/
SlpSolver.h:49, src/SlpSolver.cpp: runImpl builds the same multiple-shooting
quadratic subproblem as SQP, Ruiz-preconditions the stacked OCP data
(precondition/Ruzi.h via SlpSolver.cpp:253), estimates the cost-Hessian and
G G' eigenvalue bounds (Helpers.h, SlpSolver.cpp:268-274), and solves the QP
with the first-order PIPG method (pipg/PipgSolver.h:30) instead of a Riccati
recursion).

Here SLP *is* the SQP skeleton with ``qp_solver="pipg"``: transcription,
filter line search, AL outer loop, and convergence logic are shared
(solvers/sqp.py); the inner solve swaps the exact Riccati scan for Ruiz +
extrapolated PIPG (ops/pipg.py).  PIPG has no feedback-gain byproduct, so
the returned policy is feedforward (matching the reference SLP, which does
not extract Riccati gains).
"""
from __future__ import annotations

import dataclasses
from typing import Any, Optional

import jax

from ..oc.problem import OptimalControlProblem
from ..oc.time_discretization import TimeGrid
from .al import AlState
from . import sqp as _sqp

Array = jax.Array

SlpSolution = _sqp.SqpSolution


@dataclasses.dataclass(frozen=True)
class SlpSettings(_sqp.SqpSettings):
    """Analogue of reference slp::Settings (ocs2_slp/SlpSettings.h)."""

    qp_solver: str = "pipg"
    pipg_iterations: int = 3000
    ruiz_iterations: int = 5
    use_feedback_policy: bool = False


def solve(
    problem: OptimalControlProblem,
    grid: TimeGrid,
    x0: Array,
    params: Any,
    xs_init: Optional[Array] = None,
    us_init: Optional[Array] = None,
    al_init: Optional[AlState] = None,
    settings: SlpSettings = SlpSettings(),
) -> SlpSolution:
    return _sqp.solve(
        problem, grid, x0, params,
        xs_init=xs_init, us_init=us_init, al_init=al_init, settings=settings,
    )
