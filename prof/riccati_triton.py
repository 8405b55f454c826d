"""Batched Riccati backward pass as one Pallas kernel (Triton route, GPU).

Not used by the solvers: kept as the measured starting point for a Hopper
kernel (ROADMAP D1).  On an H100 (700 W limit) it ran the ballbot-width
sweep (nx=10, nu=3, N=32, B=4096) in 1.524 ms against 2.279 ms for the XLA
batch-minor scan, agreeing to 2.05e-6 relative, but Triton took 804.9 s to
compile it for that one shape.  `python prof/riccati_ab.py --triton` times
it beside the XLA paths.

The XLA batch-minor path (ops/riccati.py `_lqr_backward_batched`) runs the
time sweep as a `lax.scan`: on a GPU every step launches several fusions and
the (S, s) carry goes back through device memory between them.  This kernel
runs the whole sweep in one launch: the grid is over batch chunks only, each
block walks the horizon with a `fori_loop`, and the value function (S, s) is a
loop value that stays in registers.

Layout: every operand is batch-minor, [N, n, m, B]; a block owns `bc`
consecutive scenarios, so each load of one matrix entry, `ref[t, i, k, :]`,
is a coalesced [bc] vector.  The per-step math is the same entry-form
arithmetic as the XLA path (every matrix entry a [bc] vector, matmuls and
the Cholesky unrolled over the static nx, nu), so only `bc` has to be a
power of two; nx and nu need no padding.  S is symmetric and only its upper
triangle is computed and carried.

Reference analogue: the DDP backward pass (DiscreteTimeRiccatiEquations.h)
and HPIPM's internal Riccati, one scenario per GPU thread.
"""
from __future__ import annotations

import jax
import jax.numpy as jnp
from jax.experimental import pallas as pl
from jax.experimental.pallas import triton as pl_triton

from ocs2_tpu.ops.riccati import LqrCoeffs, LqrSolution

Array = jax.Array

# (batch chunk per block, warps per block).  One scenario per thread: 4096
# scenarios are only 4096 threads, so small blocks spread them over more SMs.
BLOCK_BATCH = 32
NUM_WARPS = 1


def padded_batch(batch: int, block: int) -> int:
    """The batch rounded up to whole blocks."""
    return -(-batch // block) * block


def _dot(xs, ys):
    """sum_k xs[k] * ys[k] over lists of [bc] vectors."""
    acc = xs[0] * ys[0]
    for x, y in zip(xs[1:], ys[1:]):
        acc = acc + x * y
    return acc


def _cholesky(m, eps=1e-12):
    """Entry-form lower Cholesky; m[i][j] read for j <= i only."""
    n = len(m)
    L = [[None] * n for _ in range(n)]
    for j in range(n):
        s = m[j][j]
        for k in range(j):
            s = s - L[j][k] * L[j][k]
        d = jnp.sqrt(jnp.maximum(s, eps))
        L[j][j] = d
        inv_d = 1.0 / d
        for i in range(j + 1, n):
            s = m[i][j]
            for k in range(j):
                s = s - L[i][k] * L[j][k]
            L[i][j] = s * inv_d
    return L


def _chol_solve(L, rhs):
    """Solve (L L') z = rhs for one right-hand side (list of [bc])."""
    n = len(L)
    ys = []
    for i in range(n):
        s = rhs[i]
        for k in range(i):
            s = s - L[i][k] * ys[k]
        ys.append(s / L[i][i])
    zs = [None] * n
    for i in reversed(range(n)):
        s = ys[i]
        for k in range(i + 1, n):
            s = s - L[k][i] * zs[k]
        zs[i] = s / L[i][i]
    return zs


def _kernel(
    reg_ref, a_ref, bm_ref, b_ref, qxx_ref, qx_ref, quu_ref, qu_ref, qux_ref,
    qf_ref, qfv_ref,
    gains_ref, kff_ref, vsm_ref, vsv_ref, dv_ref,
):
    n, nx, nu = bm_ref.shape[0], bm_ref.shape[1], bm_ref.shape[2]
    rx, ru = range(nx), range(nu)
    upper = [(i, j) for i in rx for j in range(i, nx)]
    reg = reg_ref[:]

    def full(tri):
        """Upper-triangle entries -> symmetric list-of-lists view."""
        S = [[None] * nx for _ in rx]
        for (i, j), v in zip(upper, tri):
            S[i][j] = S[j][i] = v
        return S

    def body(step, carry):
        s_tri, s_vec, dv1, dv2 = carry
        t = n - 1 - step
        S = full(s_tri)
        A = [[a_ref[t, i, k, :] for k in rx] for i in rx]
        Bm = [[bm_ref[t, i, u, :] for u in ru] for i in rx]
        At = [list(col) for col in zip(*A)]
        Bt = [list(col) for col in zip(*Bm)]

        b = [b_ref[t, k, :] for k in rx]
        sv = [s_vec[i] + _dot(S[i], b) for i in rx]
        qu_hat = [qu_ref[t, u, :] + _dot(Bt[u], sv) for u in ru]
        qx_hat = [qx_ref[t, i, :] + _dot(At[i], sv) for i in rx]
        SA = [[_dot(S[i], At[j]) for j in rx] for i in rx]
        SAt = [list(col) for col in zip(*SA)]
        SB = [[_dot(S[i], Bt[u]) for u in ru] for i in rx]
        SBt = [list(col) for col in zip(*SB)]
        quu_hat = [
            [quu_ref[t, u, v, :] + _dot(Bt[u], SBt[v]) for v in ru] for u in ru
        ]
        for u in ru:
            quu_hat[u][u] = quu_hat[u][u] + reg
        qux_hat = [
            [qux_ref[t, u, j, :] + _dot(Bt[u], SAt[j]) for j in rx] for u in ru
        ]
        L = _cholesky(quu_hat)
        kk_cols = [_chol_solve(L, [qux_hat[u][j] for u in ru]) for j in rx]
        kk = [[-kk_cols[j][u] for j in rx] for u in ru]       # [nu][nx]
        kf = [-z for z in _chol_solve(L, qu_hat)]              # [nu]
        kkt = [list(col) for col in zip(*kk)]                  # [nx][nu]
        quxt = [list(col) for col in zip(*qux_hat)]            # [nx][nu]
        quuk = [[_dot(quu_hat[u], [kk[v][j] for v in ru]) for j in rx]
                for u in ru]
        quukt = [list(col) for col in zip(*quuk)]              # [nx][nu]
        quukf = [_dot(quu_hat[u], kf) for u in ru]

        s_next = []
        for i, j in upper:
            qxx_sym = 0.5 * (qxx_ref[t, i, j, :] + qxx_ref[t, j, i, :])
            s_next.append(
                qxx_sym + _dot(At[i], SAt[j]) + _dot(kkt[i], quukt[j])
                + _dot(kkt[i], quxt[j]) + _dot(quxt[i], kkt[j])
            )
        sv_next = [
            qx_hat[i] + _dot(kkt[i], quukf) + _dot(kkt[i], qu_hat)
            + _dot(quxt[i], kf)
            for i in rx
        ]

        for u in ru:
            kff_ref[t, u, :] = kf[u]
            for j in rx:
                gains_ref[t, u, j, :] = kk[u][j]
        for (i, j), v in zip(upper, s_next):
            vsm_ref[t, i, j, :] = v
            if i != j:
                vsm_ref[t, j, i, :] = v
        for i in rx:
            vsv_ref[t, i, :] = sv_next[i]
        dv1 = dv1 + _dot(kf, qu_hat)
        dv2 = dv2 + 0.5 * _dot(kf, quukf)
        return tuple(s_next), tuple(sv_next), dv1, dv2

    s_tri = tuple(
        0.5 * (qf_ref[i, j, :] + qf_ref[j, i, :]) for i, j in upper
    )
    s_vec = tuple(qfv_ref[i, :] for i in rx)
    zero = jnp.zeros_like(reg)
    _, _, dv1, dv2 = jax.lax.fori_loop(0, n, body, (s_tri, s_vec, zero, zero))
    dv_ref[0, :] = dv1
    dv_ref[1, :] = dv2


def lqr_backward_pallas(
    coeffs: LqrCoeffs, reg: Array, interpret: bool = False
) -> LqrSolution:
    """Batched backward pass; coeffs leaves carry a LEADING batch dim
    [B, N, ...], reg is [B] (same contract as riccati._lqr_backward_batched).
    ``interpret`` runs the kernel in the Pallas interpreter (CPU tests)."""
    batch, n = coeffs.A.shape[0], coeffs.A.shape[1]
    nx, nu = coeffs.A.shape[2], coeffs.B.shape[3]
    dt = coeffs.A.dtype
    bc = BLOCK_BATCH
    padded = padded_batch(batch, bc)

    def batch_minor(x):
        """[B, ...] -> [..., B_padded]; padding repeats the last scenario."""
        x = jnp.moveaxis(x, 0, -1)
        pad = [(0, 0)] * (x.ndim - 1) + [(0, padded - batch)]
        return jnp.pad(x, pad, mode="edge")

    reg = jnp.broadcast_to(jnp.asarray(reg, dt), (batch,))
    operands = [batch_minor(x) for x in (reg,) + tuple(coeffs)]

    def spec(shape):
        lead = len(shape) - 1
        return pl.BlockSpec(shape[:-1] + (bc,), lambda c: (0,) * lead + (c,))

    out_shapes = [
        jax.ShapeDtypeStruct((n, nu, nx, padded), dt),  # gains
        jax.ShapeDtypeStruct((n, nu, padded), dt),      # kff
        jax.ShapeDtypeStruct((n, nx, nx, padded), dt),  # value_S, nodes 0..N-1
        jax.ShapeDtypeStruct((n, nx, padded), dt),      # value_s
        jax.ShapeDtypeStruct((2, padded), dt),          # dv1, dv2
    ]
    gains, kff, vsm, vsv, dv = pl.pallas_call(
        _kernel,
        grid=(padded // bc,),
        in_specs=[spec(x.shape) for x in operands],
        out_specs=[spec(s.shape) for s in out_shapes],
        out_shape=out_shapes,
        compiler_params=pl_triton.CompilerParams(
            num_warps=NUM_WARPS, num_stages=1
        ),
        backend="triton",
        interpret=interpret,
        name="lqr_backward_riccati",
    )(*operands)

    def standard(x):
        """[..., B_padded] -> [B, ...]."""
        return jnp.moveaxis(x[..., :batch], -1, 0)

    return LqrSolution(
        gains=standard(gains),
        kff=standard(kff),
        value_S=jnp.concatenate([standard(vsm), coeffs.Qf[:, None]], axis=1),
        value_s=jnp.concatenate([standard(vsv), coeffs.qf[:, None]], axis=1),
        dv1=standard(dv[0]),
        dv2=standard(dv[1]),
    )
