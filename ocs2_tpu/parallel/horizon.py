"""Horizon (time-axis) sharding: PIPG over a sharded horizon via shard_map.

The reference's only horizon-parallel QP solver is PIPG fanned over a
ThreadPool (ocs2_slp/src/pipg/PipgSolver.cpp:49-231); its per-stage updates
couple only through the one-step neighbor terms in G z and G' eta.  On a
device mesh that coupling is exactly a halo exchange: shard the stage axis
over a mesh axis ("time"), run the per-stage updates locally, and move the
two boundary vectors per iteration with `jax.lax.ppermute` (NVLink between
the GPUs of one host).

Decomposition (D shards, N = D*nb stages):
* shard d owns stages k in [d*nb, (d+1)*nb) and state nodes with the same
  indices; the terminal node dx_N is REPLICATED (its gradient needs one
  psum of the last shard's boundary dual per iteration).
* G z   : stage k needs dx_{k+1} — the right neighbor's first node
          (ppermute toward lower shard index).
* G' eta: the -eta_k contribution of a shard's LAST stage lands on the
          right neighbor's FIRST node (ppermute toward higher shard index).

Cost per PIPG iteration: 3 ppermutes of [nx] vectors + 1 psum — O(nx) bytes
between devices vs O(nb * nx^2) local FLOPs: communication-trivial, which is why
PIPG is the kernel of choice for horizon sharding (vs the Riccati recursion
whose associative scan moves O(nx^2) conditional-value elements).

Validated against the single-device kernel in tests/test_sharding.py.
"""
from __future__ import annotations

from functools import partial
from typing import NamedTuple

import jax
import jax.numpy as jnp
from jax.sharding import Mesh, NamedSharding, PartitionSpec as P
from jax import shard_map

from ..ops.pipg import PipgSettings, estimate_cost_eigs, estimate_sigma
from ..ops.riccati import LqrCoeffs

Array = jax.Array


class ShardedPipgSolution(NamedTuple):
    dxs: Array  # [N+1, nx] (gathered)
    dus: Array  # [N, nu]
    primal_residual: Array


def _left_halo(x_first: Array, axis: str) -> Array:
    """Each shard receives the RIGHT neighbor's first row (for dx_{k+1} of
    the local last stage).  The last shard's halo is unused (masked by the
    terminal handling)."""
    d = jax.lax.axis_size(axis)
    perm = [(i, (i - 1) % d) for i in range(d)]
    return jax.lax.ppermute(x_first, axis, perm)


def _right_spill(v_last: Array, axis: str) -> Array:
    """Each shard receives the LEFT neighbor's last-stage dual contribution
    (lands on the local first node).  Shard 0 receives the last shard's —
    masked off (node 0 is pinned anyway)."""
    d = jax.lax.axis_size(axis)
    perm = [(i, (i + 1) % d) for i in range(d)]
    return jax.lax.ppermute(v_last, axis, perm)


def pipg_solve_horizon_sharded(
    coeffs: LqrCoeffs,
    mesh: Mesh,
    settings: PipgSettings = PipgSettings(),
    axis: str = "time",
):
    """Horizon-sharded PIPG.  ``coeffs`` are stage-batched [N, ...] with N
    divisible by the mesh's ``axis`` size.  Step sizes are estimated
    globally (replicated power iteration) before the sharded loop.
    """
    n, nx = coeffs.b.shape
    nu = coeffs.B.shape[-1]
    d = mesh.shape[axis]
    assert n % d == 0, f"horizon {n} not divisible by mesh axis {d}"
    dt = coeffs.b.dtype

    # Global step sizes (cheap, replicated — matches single-device kernel).
    mu, lam = estimate_cost_eigs(coeffs, settings.power_iterations)
    sigma = settings.sigma_safety * jnp.abs(
        estimate_sigma(coeffs, settings.power_iterations)
    )
    omega = jnp.maximum(lam, 1e-6)
    alpha = 2.0 / (jnp.sqrt(mu * mu + 4.0 * omega * sigma) + mu)
    beta = omega * alpha
    rho = settings.relaxation

    stage_spec = P(axis)  # shard leading (stage) axis
    rep = P()

    def local_iteration(A, B, b, Qxx, qx, Quu, qu, Qux, Qf, qf):
        """Body under shard_map: all stage arrays are LOCAL blocks [nb, ...];
        Qf/qf replicated."""
        nb = A.shape[0]
        shard = jax.lax.axis_index(axis)
        is_last = shard == d - 1
        is_first = shard == 0

        def g_matvec(zx, zxN, zu):
            """Local dynamics rows: A zx + B zu - zx_next."""
            halo = _left_halo(zx[0], axis)  # right neighbor's first node
            zx_next = jnp.concatenate(
                [zx[1:], jnp.where(is_last, zxN, halo)[None]], axis=0
            )
            return (
                jnp.einsum("kxy,ky->kx", A, zx)
                + jnp.einsum("kxu,ku->kx", B, zu)
                - zx_next
            )

        def gt_matvec(eta):
            """Local G' eta on (nodes, inputs, terminal)."""
            gx = jnp.einsum("kxy,kx->ky", A, eta)  # to own node k
            # -eta_{k-1} to node k: local shift + spill to the right neighbor.
            spill = _right_spill(eta[-1], axis)  # left neighbor's last dual
            minus = jnp.concatenate(
                [jnp.where(is_first, 0.0, spill)[None], eta[:-1]], axis=0
            )
            gx = gx - minus
            gu = jnp.einsum("kxu,kx->ku", B, eta)
            # Terminal: -eta_{N-1} (only the last shard holds it) -> psum.
            gxN = jax.lax.psum(jnp.where(is_last, -eta[-1], 0.0), axis)
            return gx, gu, gxN

        def cost_matvec(zx, zxN, zu):
            gx = (
                jnp.einsum("kxy,ky->kx", Qxx, zx)
                + jnp.einsum("kux,ku->kx", Qux, zu)
            )
            gu = jnp.einsum("kuv,kv->ku", Quu, zu) + jnp.einsum(
                "kux,kx->ku", Qux, zx
            )
            gxN = Qf @ zxN
            return gx, gu, gxN

        def body(_, carry):
            zx, zxN, zu, w = carry
            v = w + beta * (g_matvec(zx, zxN, zu) + b)
            cgx, cgu, cgxN = cost_matvec(zx, zxN, zu)
            ggx, ggu, ggxN = gt_matvec(v)
            zx_n = zx - alpha * (cgx + qx + ggx)
            # Pin dx_0 = 0 (only the first shard owns node 0).
            zx_n = jnp.where(
                is_first,
                zx_n.at[0].set(0.0),
                zx_n,
            )
            zxN_n = zxN - alpha * (cgxN + qf + ggxN)
            zu_n = zu - alpha * (cgu + qu + ggu)
            w_n = w + beta * (g_matvec(zx_n, zxN_n, zu_n) + b)
            return (
                (1.0 - rho) * zx + rho * zx_n,
                (1.0 - rho) * zxN + rho * zxN_n,
                (1.0 - rho) * zu + rho * zu_n,
                w_n,
            )

        zx = jnp.zeros((nb, nx), dt)
        zxN = jnp.zeros((nx,), dt)
        zu = jnp.zeros((nb, nu), dt)
        w = jnp.zeros((nb, nx), dt)
        zx, zxN, zu, w = jax.lax.fori_loop(
            0, settings.num_iterations, body, (zx, zxN, zu, w)
        )
        res = jnp.max(jnp.abs(g_matvec(zx, zxN, zu) + b))
        res = jax.lax.pmax(res, axis)
        return zx, zxN, zu, res

    sharded = shard_map(
        local_iteration,
        mesh=mesh,
        in_specs=(
            stage_spec, stage_spec, stage_spec, stage_spec, stage_spec,
            stage_spec, stage_spec, stage_spec, rep, rep,
        ),
        out_specs=(stage_spec, rep, stage_spec, rep),
        check_vma=False,
    )
    zx, zxN, zu, res = sharded(
        coeffs.A, coeffs.B, coeffs.b, coeffs.Qxx, coeffs.qx,
        coeffs.Quu, coeffs.qu, coeffs.Qux, coeffs.Qf, coeffs.qf,
    )
    dxs = jnp.concatenate([zx, zxN[None]], axis=0)
    return ShardedPipgSolution(dxs=dxs, dus=zu, primal_residual=res)
