"""Continuous-time Riccati ODE backward pass — the SLQ backward sweep.

JAX-native analogue of the reference's continuous-time SLQ machinery
(ocs2_ddp/include/ocs2_ddp/SLQ.h:43, riccati_equations/
ContinuousTimeRiccatiEquations.h:106): instead of the discrete recursion,
the value-function coefficients (S, s) solve the Riccati ODE

    -dS/dt = Q + A'S + SA - (P + B'S)' R^{-1} (P + B'S)
    -ds/dt = q + A's - (P + B'S)' R^{-1} (r + B's)

with A(t), B(t) the CONTINUOUS-TIME dynamics linearization and
(Q, q, R, r, P) the running-cost RATE quadratization along the nominal
trajectory.  The reference integrates this with ODE45 over each interval,
interpolating the model data linearly in time; here each interval is
integrated with ``substeps`` fixed RK4 steps of the matrix ODE inside one
reverse ``lax.scan`` over the horizon — static shapes, no data-dependent
control flow, the whole sweep one fused XLA program.  (The adaptive DP5(4)
stepper exists in core/integrate.py; fixed substeps keep the backward pass
tileable and are validated against the reference fixtures to the same
tolerance — see tests/test_ddp.py.)

Event handling follows the reference pre-jump update (SLQ.cpp
riccatiTransversalityConditions): at a jump interval the ODE is replaced by
the discrete map  S- = Aj' S+ Aj + Qjump,  s- = Aj' s+ + qjump.

The returned LqrSolution matches ops/riccati.py's shapes, so the DDP
line-search / forward machinery is shared between iLQR and SLQ.
"""
from __future__ import annotations

from typing import NamedTuple

import jax
import jax.numpy as jnp

from ..core.types import symmetrize
from .riccati import LqrSolution, _solve_psd

Array = jax.Array


class CtLqCoeffs(NamedTuple):
    """Node-sampled continuous-time LQ data.

    Node arrays have N+1 rows (value at grid node k); within interval
    [t_k, t_{k+1}] coefficients are interpolated linearly (the reference's
    LinearInterpolation of ModelData along the nominal time grid).
    Jump arrays have N rows (per interval; used only where is_jump = 1).
    """

    A: Array       # [N+1, nx, nx]  continuous dfdx
    B: Array       # [N+1, nx, nu]  continuous dfdu
    Q: Array       # [N+1, nx, nx]  cost-rate Hessian d2l/dx2
    q: Array       # [N+1, nx]      cost-rate gradient dl/dx
    R: Array       # [N+1, nu, nu]
    r: Array       # [N+1, nu]
    P: Array       # [N+1, nu, nx]  cross term d2l/dudx
    A_jump: Array  # [N, nx, nx]    jump-map linearization
    Q_jump: Array  # [N, nx, nx]    pre-jump cost Hessian
    q_jump: Array  # [N, nx]        pre-jump cost gradient
    Qf: Array      # [nx, nx]       terminal quadratic
    qf: Array      # [nx]
    times: Array   # [N+1]
    is_jump: Array  # [N]           1.0 where the interval is an event


def _riccati_rhs(S, s, a, b_mat, q_mat, q_vec, r_mat, r_vec, p_mat, reg):
    """Forward-time dS/dt, ds/dt (both negated Riccati RHS)."""
    nu = r_mat.shape[0]
    rr = r_mat + reg * jnp.eye(nu, dtype=r_mat.dtype)
    g_mat = p_mat + b_mat.T @ S          # [nu, nx]
    g_vec = r_vec + b_mat.T @ s          # [nu]
    k_mat = _solve_psd(rr, g_mat)
    k_vec = _solve_psd(rr, g_vec)
    dS = -(q_mat + a.T @ S + S @ a - g_mat.T @ k_mat)
    ds = -(q_vec + a.T @ s - g_mat.T @ k_vec)
    return symmetrize(dS), ds


def slq_backward(
    coeffs: CtLqCoeffs, reg: Array | float = 0.0, substeps: int = 4
) -> LqrSolution:
    """Integrate the Riccati ODE backward over the horizon.

    Per interval: ``substeps`` RK4 steps with linearly interpolated
    coefficients; jump intervals apply the discrete transversality update.
    Gains/feedforward are extracted at each node from the continuous-time
    optimality condition  u* = -R^{-1}[(P + B'S) dx + (r + B's)].
    """
    reg = jnp.asarray(reg)
    n = coeffs.A_jump.shape[0]
    dts = coeffs.times[1:] - coeffs.times[:-1]

    def interval(carry, stage):
        s_mat, s_vec = carry
        (a0, a1, b0, b1, qm0, qm1, qv0, qv1, rm0, rm1, rv0, rv1, pm0, pm1,
         aj, qj_mat, qj_vec, dt, m) = stage

        # -- smooth branch: RK4 backward with linear-in-time coefficients ----
        h = -dt / substeps  # negative step: integrate t_{k+1} -> t_k

        def coeff_at(theta):
            """theta in [0, 1] measured from node k."""
            w = theta
            return (
                a0 + w * (a1 - a0), b0 + w * (b1 - b0),
                qm0 + w * (qm1 - qm0), qv0 + w * (qv1 - qv0),
                rm0 + w * (rm1 - rm0), rv0 + w * (rv1 - rv0),
                pm0 + w * (pm1 - pm0),
            )

        def rk4_body(i, ys):
            S, s = ys
            # current backward position: theta = 1 - i/substeps
            th0 = 1.0 - i / substeps
            thh = th0 + 0.5 * h / jnp.maximum(dt, 1e-12)
            th1 = th0 + h / jnp.maximum(dt, 1e-12)
            k1 = _riccati_rhs(S, s, *coeff_at(th0), reg)
            k2 = _riccati_rhs(S + 0.5 * h * k1[0], s + 0.5 * h * k1[1],
                              *coeff_at(thh), reg)
            k3 = _riccati_rhs(S + 0.5 * h * k2[0], s + 0.5 * h * k2[1],
                              *coeff_at(thh), reg)
            k4 = _riccati_rhs(S + h * k3[0], s + h * k3[1],
                              *coeff_at(th1), reg)
            S_n = S + (h / 6.0) * (k1[0] + 2 * k2[0] + 2 * k3[0] + k4[0])
            s_n = s + (h / 6.0) * (k1[1] + 2 * k2[1] + 2 * k3[1] + k4[1])
            return (symmetrize(S_n), s_n)

        s_ode, v_ode = jax.lax.fori_loop(0, substeps, rk4_body, (s_mat, s_vec))

        # -- jump branch: transversality update ------------------------------
        s_jmp = symmetrize(aj.T @ s_mat @ aj + qj_mat)
        v_jmp = aj.T @ s_vec + qj_vec

        s_k = (1.0 - m) * s_ode + m * s_jmp
        v_k = (1.0 - m) * v_ode + m * v_jmp

        # Node-k gain extraction (continuous-time optimality condition).
        nu = rm0.shape[0]
        rr = rm0 + reg * jnp.eye(nu, dtype=rm0.dtype)
        g_mat = pm0 + b0.T @ s_k
        g_vec = rv0 + b0.T @ v_k
        kk = -_solve_psd(rr, g_mat)
        kf = -_solve_psd(rr, g_vec)
        # Expected merit decrease, integrated as node rates (zero at jumps).
        dv1 = dt * (1.0 - m) * (kf @ g_vec)
        dv2 = 0.5 * dt * (1.0 - m) * (kf @ rr @ kf)
        return (s_k, v_k), (kk, kf, s_k, v_k, dv1, dv2)

    stages = (
        coeffs.A[:-1], coeffs.A[1:], coeffs.B[:-1], coeffs.B[1:],
        coeffs.Q[:-1], coeffs.Q[1:], coeffs.q[:-1], coeffs.q[1:],
        coeffs.R[:-1], coeffs.R[1:], coeffs.r[:-1], coeffs.r[1:],
        coeffs.P[:-1], coeffs.P[1:],
        coeffs.A_jump, coeffs.Q_jump, coeffs.q_jump, dts, coeffs.is_jump,
    )
    _, (ks, kffs, s_mats, s_vecs, dv1s, dv2s) = jax.lax.scan(
        interval, (coeffs.Qf, coeffs.qf), stages, reverse=True
    )
    value_S = jnp.concatenate([s_mats, coeffs.Qf[None]], axis=0)
    value_s = jnp.concatenate([s_vecs, coeffs.qf[None]], axis=0)
    return LqrSolution(
        gains=ks,
        kff=kffs,
        value_S=value_S,
        value_s=value_s,
        dv1=jnp.sum(dv1s),
        dv2=jnp.sum(dv2s),
    )
