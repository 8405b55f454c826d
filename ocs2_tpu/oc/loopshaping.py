"""Loopshaping: frequency-domain cost shaping via input-filter augmentation.

JAX-native re-design of the reference loopshaping machinery
(ocs2_core/include/ocs2_core/loopshaping/: LoopshapingDefinition.h:44-49 with
its two patterns, the dynamics wrapper loopshaping/dynamics/
LoopshapingDynamics.h, and the cost/constraint/soft-constraint wrappers under
loopshaping/{cost,constraint,soft_constraint}/; the property-tree loader
LoopshapingPropertyTree.h becomes plain config fields in utils/config.py).

Where the reference wraps every problem ingredient in a decorator class
hierarchy, here loopshaping is **one pure function from problem to problem**:
the augmented system state is x_aug = (x, xi) with xi the input-filter state,
the new decision input is v, and the plant input is u = C xi + D v (the
reference's *output pattern*; the *eliminate pattern* additionally removes u
as an algebraic variable, which in this representation is the same closure —
the filter is strictly proper, D = 0).  Every original cost/constraint term
is evaluated at (x, u(xi, v)) — XLA fuses the substitution for free; no
wrapper objects exist at runtime.

Filter dynamics:  xi' = A xi + B v,   u = C xi + D v.
"""
from __future__ import annotations

import dataclasses
from typing import NamedTuple, Optional

import jax
import jax.numpy as jnp

from .problem import OptimalControlProblem

Array = jax.Array


class LoopshapingDefinition(NamedTuple):
    """Input-filter state space (reference LoopshapingDefinition.h).

    A [nf, nf], B [nf, nv], C [nu, nf], D [nu, nv].  R_v is an optional
    quadratic penalty on the filtered input v (the shaping weight).
    """

    A: Array
    B: Array
    C: Array
    D: Array
    R_v: Optional[Array] = None

    @property
    def num_filter_states(self) -> int:
        return self.A.shape[0]

    @property
    def num_filtered_inputs(self) -> int:
        return self.B.shape[1]

    def filter_input(self, xi: Array, v: Array) -> Array:
        """Plant input u = C xi + D v (LoopshapingDefinition::getSystemInput)."""
        return self.C @ xi + self.D @ v

    def equilibrium_filter_state(self, u: Array) -> Array:
        """xi with C xi = u and xi' = 0 for the steady plant input — used to
        augment observations (reference LoopshapingSystemObservation /
        augmentedSystemState).  Least-squares when C is not square."""
        sol = jnp.linalg.lstsq(self.C, u)[0]
        return sol


def first_order_filter(
    nu: int, pole: float, zero: float, gain: float = 1.0, dtype=jnp.float32
) -> LoopshapingDefinition:
    """Diagonal first-order shaping filter s -> gain*(s+zero)/(s+pole) per
    input channel (the common configuration in the reference's loopshaping
    .info files, e.g. ocs2_anymal_loopshaping_mpc)."""
    eye = jnp.eye(nu, dtype=dtype)
    return LoopshapingDefinition(
        A=-pole * eye,
        B=eye,
        C=gain * (zero - pole) * eye,
        D=gain * eye,
    )


def augment_observation(defn: LoopshapingDefinition, x: Array, u: Array) -> Array:
    """(x, u) -> x_aug for warm starts / initial conditions."""
    return jnp.concatenate([x, defn.equilibrium_filter_state(u)])


def split_state(defn: LoopshapingDefinition, x_aug: Array):
    nf = defn.num_filter_states
    return x_aug[:-nf], x_aug[-nf:]


def wrap_problem_r_filter(
    problem: OptimalControlProblem,
    defn: LoopshapingDefinition,
) -> OptimalControlProblem:
    """The reference's TRUE outputpattern (r_filter route,
    LoopshapingPropertyTree.cpp:154: 'The system inputs remain the inputs of
    the augmented system. Loopshaping inputs are a linear combination of
    state and system inputs', LoopshapingDefinition.h:39-44):

        x_aug = [x, xi],  xi' = A xi + B u,   input stays u,
        extra cost  1/2 y' R_v y  with  y = C xi + D u  (getFilteredInput).

    Every original cost/constraint term is untouched (same classification,
    same u-Jacobians — projection/AL machinery identical to the unshaped
    problem); only the dynamics gain the filter block and the cost gains the
    filtered-output penalty.  With the filter chosen as y = s_inv(s)·u this
    penalizes exactly the anymal loopshaping transfer of the input."""
    nx, nf = problem.nx, defn.num_filter_states
    assert defn.R_v is not None, "r_filter pattern needs the shaping weight R_v"

    def dynamics(t, xa, u, p):
        x, xi = xa[:nx], xa[nx:]
        dx = problem.dynamics(t, x, u, p)
        dxi = defn.A @ xi + defn.B @ u
        return jnp.concatenate([dx, dxi])

    def wrap_xu(term):
        def fn(t, xa, u, p):
            return term(t, xa[:nx], u, p)

        return fn

    def wrap_x(term):
        def fn(t, xa, p):
            return term(t, xa[:nx], p)

        return fn

    def shaping_cost(t, xa, u, p):
        y = defn.C @ xa[nx:] + defn.D @ u
        return 0.5 * y @ defn.R_v @ y

    jump_map = None
    if problem.jump_map is not None:

        def jump_map(t, xa, p):
            x_next = problem.apply_jump(t, xa[:nx], p)
            return jnp.concatenate([x_next, xa[nx:]])

    return dataclasses.replace(
        problem,
        dynamics=dynamics,
        nx=nx + nf,
        cost_terms=tuple(wrap_xu(c) for c in problem.cost_terms)
        + (shaping_cost,),
        state_cost_terms=tuple(wrap_x(c) for c in problem.state_cost_terms),
        pre_jump_cost_terms=tuple(
            wrap_x(c) for c in problem.pre_jump_cost_terms
        ),
        final_cost_terms=tuple(wrap_x(c) for c in problem.final_cost_terms),
        equality_terms=tuple(wrap_xu(g) for g in problem.equality_terms),
        inequality_terms=tuple(wrap_xu(g) for g in problem.inequality_terms),
        state_equality_terms=tuple(
            wrap_x(g) for g in problem.state_equality_terms
        ),
        state_inequality_terms=tuple(
            wrap_x(g) for g in problem.state_inequality_terms
        ),
        final_equality_terms=tuple(
            wrap_x(g) for g in problem.final_equality_terms
        ),
        jump_map=jump_map,
    )


def wrap_problem(
    problem: OptimalControlProblem,
    defn: LoopshapingDefinition,
    pattern: str = "output",  # "output" | "eliminate"
) -> OptimalControlProblem:
    """Loopshaping augmentation as a problem-to-problem transform (replacing
    the reference's LoopshapingDynamics/Cost/Constraint wrapper hierarchy).

    Returns a problem with nx + nf states and nv inputs whose solutions,
    restricted to the plant block, solve the shaped control problem.

    pattern="output": u = C xi + D v (reference outputPattern) — original
    terms keep their state-input classification.
    pattern="eliminate" (reference eliminatePattern, requires D = 0): the
    plant input is a pure function of the FILTER STATE, u = C xi, so every
    original state-input cost/constraint becomes a STATE-ONLY term of the
    augmented problem — crucially this keeps the projection/AL machinery
    rank-correct (a "state-input" constraint with an all-zero v-Jacobian
    would break the QR null-space projection)."""
    nx, nf = problem.nx, defn.num_filter_states
    nv = defn.num_filtered_inputs
    if pattern not in ("output", "eliminate"):
        raise ValueError(f"unknown loopshaping pattern {pattern!r}")
    eliminate = pattern == "eliminate"
    if eliminate:
        import numpy as _np

        assert _np.allclose(_np.asarray(defn.D), 0.0), (
            "eliminate pattern requires a strictly proper filter (D = 0)"
        )
        assert defn.R_v is not None, (
            "eliminate pattern needs R_v: with every original cost now "
            "state-only, the shaping penalty is the ONLY input cost "
            "(otherwise Quu is singular)"
        )

    def split(t, xa, v, p):
        x, xi = xa[:nx], xa[nx:]
        u = defn.filter_input(xi, v)
        return x, xi, u

    def dynamics(t, xa, v, p):
        x, xi, u = split(t, xa, v, p)
        dx = problem.dynamics(t, x, u, p)
        dxi = defn.A @ xi + defn.B @ v
        return jnp.concatenate([dx, dxi])

    def wrap_cost(term):
        def cost(t, xa, v, p):
            x, xi, u = split(t, xa, v, p)
            return term(t, x, u, p)

        return cost

    def wrap_state_term(term):
        def fn(t, xa, p):
            return term(t, xa[:nx], p)

        return fn

    def wrap_constraint(term):
        def g(t, xa, v, p):
            x, xi, u = split(t, xa, v, p)
            return term(t, x, u, p)

        return g

    extra_cost = ()
    if defn.R_v is not None:

        def shaping_cost(t, xa, v, p):
            return 0.5 * v @ defn.R_v @ v

        extra_cost = (shaping_cost,)

    def as_state_term(term):
        """Eliminate pattern: a state-input term of the original problem is
        a pure STATE term of the augmented one, u = C xi."""

        def fn(t, xa, p):
            x, xi = xa[:nx], xa[nx:]
            return term(t, x, defn.C @ xi, p)

        return fn

    jump_map = None
    if problem.jump_map is not None:

        def jump_map(t, xa, p):
            x_next = problem.apply_jump(t, xa[:nx], p)
            return jnp.concatenate([x_next, xa[nx:]])

    if eliminate:
        return dataclasses.replace(
            problem,
            dynamics=dynamics,
            nx=nx + nf,
            nu=nv,
            cost_terms=extra_cost,
            state_cost_terms=tuple(
                as_state_term(c) for c in problem.cost_terms
            )
            + tuple(wrap_state_term(c) for c in problem.state_cost_terms),
            pre_jump_cost_terms=tuple(
                wrap_state_term(c) for c in problem.pre_jump_cost_terms
            ),
            final_cost_terms=tuple(
                wrap_state_term(c) for c in problem.final_cost_terms
            ),
            equality_terms=(),
            inequality_terms=(),
            state_equality_terms=tuple(
                as_state_term(g) for g in problem.equality_terms
            )
            + tuple(wrap_state_term(g) for g in problem.state_equality_terms),
            state_inequality_terms=tuple(
                as_state_term(g) for g in problem.inequality_terms
            )
            + tuple(wrap_state_term(g) for g in problem.state_inequality_terms),
            final_equality_terms=tuple(
                wrap_state_term(g) for g in problem.final_equality_terms
            ),
            jump_map=jump_map,
        )

    return dataclasses.replace(
        problem,
        dynamics=dynamics,
        nx=nx + nf,
        nu=nv,
        cost_terms=tuple(wrap_cost(c) for c in problem.cost_terms) + extra_cost,
        state_cost_terms=tuple(
            wrap_state_term(c) for c in problem.state_cost_terms
        ),
        pre_jump_cost_terms=tuple(
            wrap_state_term(c) for c in problem.pre_jump_cost_terms
        ),
        final_cost_terms=tuple(
            wrap_state_term(c) for c in problem.final_cost_terms
        ),
        equality_terms=tuple(wrap_constraint(g) for g in problem.equality_terms),
        inequality_terms=tuple(
            wrap_constraint(g) for g in problem.inequality_terms
        ),
        state_equality_terms=tuple(
            wrap_state_term(g) for g in problem.state_equality_terms
        ),
        state_inequality_terms=tuple(
            wrap_state_term(g) for g in problem.state_inequality_terms
        ),
        final_equality_terms=tuple(
            wrap_state_term(g) for g in problem.final_equality_terms
        ),
        jump_map=jump_map,
    )


def load_loopshaping_info(source: str) -> tuple:
    """Load a reference loopshaping ``.info`` file into a
    (LoopshapingDefinition, pattern) pair — the analogue of
    ocs2_core/src/loopshaping/LoopshapingPropertyTree.cpp:143-160:

    * an ``r_filter`` section -> the outputpattern (use with
      wrap_problem_r_filter: filter driven by u, shaping cost on y),
    * an ``s_inv_filter`` section -> the eliminatepattern with the INVERTED
      filter (use with wrap_problem: u = C xi + D v).

    Each filter is a concatenation of SISO first-order sections
    (numFilters / FilterK { numRepeats, scaling, zeros { (0) z }, poles
    { (0) p } }); only the 1-pole/1-zero sections the shipped configs use
    are supported.  ``source`` is the .info text or a path.
    """
    import numpy as np

    from ..utils.config import get_path, load_info, parse_info

    tree = (
        parse_info(source)
        if "\n" in source or "{" in source
        else load_info(source)
    )

    def read_mimo(section: str, invert: bool):
        sec = tree.get(section)
        if not sec:
            return None
        k = int(float(sec.get("numFilters", 0)))
        gains, poles, zeros = [], [], []
        for i in range(k):
            f = sec[f"Filter{i}"]
            reps = int(float(f.get("numRepeats", 1)))
            g = float(f.get("scaling", 1.0))
            z = float(f["zeros"]["(0)"]) if "zeros" in f else 0.0
            p_ = float(f["poles"]["(0)"]) if "poles" in f else 0.0
            gains += [g] * reps
            poles += [p_] * reps
            zeros += [z] * reps
        g = np.asarray(gains)
        p_ = -np.asarray(poles)  # info stores the pole location (negative)
        z = -np.asarray(zeros)
        if invert:
            # invert H = g (s+z)/(s+p)  ->  (1/g)(s+p)/(s+z).
            g, p_, z = 1.0 / g, z, p_
        n = len(g)
        # Realization of H(s) = g (s+z)/(s+p): A=-p, B=1, C=g(z-p), D=g.
        return LoopshapingDefinition(
            A=jnp.asarray(np.diag(-p_), jnp.float32),
            B=jnp.eye(n, dtype=jnp.float32),
            C=jnp.asarray(np.diag(g * (z - p_)), jnp.float32),
            D=jnp.asarray(np.diag(g), jnp.float32),
            R_v=jnp.eye(n, dtype=jnp.float32),  # default costMatrix identity
        )

    r = read_mimo("r_filter", invert=False)
    s = read_mimo("s_inv_filter", invert=True)
    if r is not None and s is not None:
        raise ValueError("using both r and s filter not implemented")
    if r is not None:
        return r, "output"
    if s is not None:
        return s, "eliminate"
    raise ValueError("no valid loopshaping filter found")
