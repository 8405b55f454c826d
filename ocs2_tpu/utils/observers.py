"""Solver observability: performance-index history, term probes, benchmarks.

JAX-native analogue of the reference's observability stack:
* SolverObserver term-wise probes of constraints/Lagrangians/multipliers
  (ocs2_oc/synchronized_module/SolverObserver.h:48-152) — here callbacks
  over the *solution pytree* after each solve (everything the reference
  observes per term is already materialized in TrajectoryMetrics/AlState).
* PerformanceIndex iteration history (ocs2_oc/oc_solver/SolverBase.h:154-168).
* Per-phase benchmark breakdown printout (GaussNewtonDDP.cpp:140-165,
  SqpSolver.cpp:128-150) built from utils/timers.RepeatedTimer.
"""
from __future__ import annotations

import dataclasses
from typing import Any, Callable, Dict, List, Optional

import jax
import jax.numpy as jnp
import numpy as np

from ..core.types import PerformanceIndex
from .timers import RepeatedTimer

Array = jax.Array


@dataclasses.dataclass
class SolverObserver:
    """Observes a named quantity of each solve (SolverObserver.h analogue).

    extractor(solution) -> pytree of arrays; every observation is appended
    to ``history`` with its solve time.  Typical extractors probe constraint
    values, AL multipliers, or solver statistics.
    """

    name: str
    extractor: Callable[[Any], Any]
    history: List[tuple] = dataclasses.field(default_factory=list)

    def observe(self, t: float, solution: Any) -> None:
        value = jax.tree.map(np.asarray, self.extractor(solution))
        self.history.append((t, value))

    def latest(self):
        return self.history[-1] if self.history else None


def constraint_observer(name: str = "equality_sse") -> SolverObserver:
    """Probe of the terminal equality-constraint SSE (the reference's
    LagrangianMetrics topics)."""
    return SolverObserver(
        name=name,
        extractor=lambda sol: sol.performance.equality_constraints_sse,
    )


def multiplier_observer(name: str = "multipliers") -> SolverObserver:
    """Probe of AL multipliers (reference SolverObserver multiplier
    callbacks)."""
    return SolverObserver(name=name, extractor=lambda sol: sol.al)


@dataclasses.dataclass
class PerformanceLog:
    """Per-solve PerformanceIndex history (SolverBase performanceIndeces_)."""

    entries: List[PerformanceIndex] = dataclasses.field(default_factory=list)

    def append(self, perf: PerformanceIndex) -> None:
        self.entries.append(jax.tree.map(lambda a: float(np.asarray(a)), perf))

    def latest(self) -> Optional[PerformanceIndex]:
        return self.entries[-1] if self.entries else None

    def as_arrays(self) -> Dict[str, np.ndarray]:
        if not self.entries:
            return {}
        return {
            field: np.asarray([getattr(e, field) for e in self.entries])
            for field in PerformanceIndex._fields
        }


# --------------------------------------------------------------------------
# Term-wise probes (reference SolverObserver::ConstraintTermObserver /
# LagrangianTermObserver, SolverObserver.h:48-152): extract ONE named term's
# per-node constraint values / AL multipliers from a solution, with optional
# callbacks — the feed for plotting/telemetry sinks
# (SolverObserverRosCallbacks.h analogue).
# --------------------------------------------------------------------------

_FAMILY_ATTR = {
    "equality": ("equality_terms", True),
    "state_equality": ("state_equality_terms", False),
    "inequality": ("inequality_terms", True),
    "state_inequality": ("state_inequality_terms", False),
    "final_equality": ("final_equality_terms", False),
}
_FAMILY_MULT = {
    "equality": "lmbd_eq",
    "state_equality": "lmbd_state_eq",
    "inequality": "lmbd_ineq",
    "state_inequality": "lmbd_state_ineq",
    "final_equality": "lmbd_final_eq",
}


def term_name(fn) -> str:
    """Display name of a term callable (the reference keys observers by the
    name the term was added under; here the function/class name, or an
    explicit ``fn.name`` attribute)."""
    return getattr(fn, "name", None) or getattr(
        fn, "__name__", type(fn).__name__
    )


def term_slices(problem, family: str, params_example) -> Dict[str, slice]:
    """{term name: row slice} inside the family's stacked constraint vector
    (stacking order = term tuple order, oc/problem._cat_terms)."""
    attr, with_u = _FAMILY_ATTR[family]
    terms = getattr(problem, attr)
    t = jnp.zeros(())
    x = jax.ShapeDtypeStruct((problem.nx,), jnp.float32)
    u = jax.ShapeDtypeStruct((problem.nu,), jnp.float32)
    if isinstance(params_example, dict):
        params_example = dict(params_example)
        params_example.setdefault("mode", jnp.zeros((), jnp.int32))
        params_example.setdefault("node", jnp.zeros((), jnp.int32))
    out, off = {}, 0
    for fn in terms:
        args = (t, x, u, params_example) if with_u else (t, x, params_example)
        shape = jax.eval_shape(lambda *a: jnp.atleast_1d(fn(*a)), *args).shape
        out[term_name(fn)] = slice(off, off + shape[0])
        off += shape[0]
    return out


def evaluate_term(problem, grid, xs, us, params, family: str, name: str):
    """[N(+1), dim] per-node values of the named constraint term over a
    trajectory (the extraction half of ConstraintTermObserver)."""
    from ..oc.approx import node_params

    attr, with_u = _FAMILY_ATTR[family]
    fn = next(f for f in getattr(problem, attr) if term_name(f) == name)
    n = us.shape[0]
    # Device views of the grid: numpy leaves cannot be indexed by the
    # traced node index under vmap.
    grid = jax.tree.map(jnp.asarray, grid)

    def node(k):
        p = node_params(params, grid, k)
        t = grid.times[k]
        if with_u:
            return jnp.atleast_1d(fn(t, xs[k], us[k], p))
        return jnp.atleast_1d(fn(t, xs[k], p))

    count = n if with_u else n + 1
    if family == "final_equality":
        p = node_params(params, grid, n)
        return jnp.atleast_1d(fn(grid.times[n], xs[n], p))[None]
    return jax.vmap(node)(jnp.arange(count))


@dataclasses.dataclass
class TermObserver:
    """Named-term probe with constraint/multiplier callbacks
    (SolverObserver::ConstraintTermObserver + LagrangianTermObserver).

    `observe(t, grid, sol, params)` extracts the term's per-node values
    (and, when the solution carries an AlState, its multiplier rows),
    appends them to history, and invokes the callbacks with
    (timestamps [N], values [N, dim]).
    """

    problem: Any
    family: str
    term: str
    constraint_callback: Optional[Callable] = None
    multiplier_callback: Optional[Callable] = None
    history: List[tuple] = dataclasses.field(default_factory=list)

    def observe(self, t: float, grid, sol, params) -> None:
        vals = np.asarray(
            evaluate_term(
                self.problem, grid, sol.xs, sol.us, params, self.family,
                self.term,
            )
        )
        times = np.asarray(grid.times)[: vals.shape[0]]
        mults = None
        al = getattr(sol, "al", None)
        if al is not None:
            sl = term_slices(self.problem, self.family, params)[self.term]
            fam = np.asarray(getattr(al, _FAMILY_MULT[self.family]))
            mults = fam[..., sl]
        self.history.append((t, times, vals, mults))
        if self.constraint_callback is not None:
            self.constraint_callback(times, vals)
        if self.multiplier_callback is not None and mults is not None:
            self.multiplier_callback(times, mults)

    def latest(self):
        return self.history[-1] if self.history else None


def benchmark_report(timers: Dict[str, RepeatedTimer]) -> str:
    """Percentage breakdown string (getBenchmarkingInfo analogue,
    GaussNewtonDDP.cpp:140-165)."""
    total = sum(t.total for t in timers.values()) or 1.0
    lines = ["Benchmarking [ms and % of total]:"]
    for name, t in timers.items():
        lines.append(
            f"  {name:<24s} avg {t.average * 1e3:8.3f} ms  "
            f"max {t.max * 1e3:8.3f} ms  ({100.0 * t.total / total:5.1f}%)"
        )
    return "\n".join(lines)
