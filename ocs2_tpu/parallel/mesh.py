"""Scale-out: batched and mesh-sharded scenario solving.

This is the JAX-native replacement for everything the reference does with
threads and processes (SURVEY.md §2.9): ThreadPool fan-out over horizon
nodes/line-search candidates becomes vmap (solvers already do this
internally); here the *scenario* axis — thousands of independent MPC solves
(different initial states, targets, model parameters) — is batched per device
with vmap and sharded across devices with `jax.sharding` + jit, with XLA
inserting the collectives (NCCL between GPUs).

The reference has no multi-robot/multi-scenario scaling story at all; this
module is the framework's headline superpower (BASELINE.md: >=10k batched
SLQ solves/s per host, >=80% multi-host scaling).
"""
from __future__ import annotations

from typing import Any, Callable, Optional, Sequence

import jax
import jax.numpy as jnp
import numpy as np
from jax.sharding import Mesh, NamedSharding, PartitionSpec as P

Array = jax.Array


def make_mesh(
    devices: Optional[Sequence[jax.Device]] = None, axis_name: str = "scenario"
) -> Mesh:
    """1-D device mesh over all (or given) devices for scenario parallelism.

    The GPUs of one host are joined all to all, so one axis over all of
    them is the natural layout; jax's global device list would extend the
    same axis across hosts without a change to the sharding spec.
    """
    devices = list(devices) if devices is not None else jax.devices()
    return Mesh(np.asarray(devices), (axis_name,))


def batched(solve_fn: Callable) -> Callable:
    """vmap a single-scenario solve over leading-axis batches (per device)."""
    return jax.vmap(solve_fn)


def sharded(
    solve_fn: Callable,
    mesh: Mesh,
    axis_name: str = "scenario",
    donate: bool = False,
) -> Callable:
    """Compile a batched solve with the batch axis sharded over the mesh.

    `solve_fn(x0, *args)` is vmapped, then jitted with the leading axis of
    every argument and result sharded over ``axis_name``.  Batch size must be
    divisible by the mesh size.  Replicated (non-batched) arguments should be
    closed over in ``solve_fn``.
    """
    spec = NamedSharding(mesh, P(axis_name))

    vmapped = jax.vmap(solve_fn)

    @jax.jit
    def run(*batched_args):
        placed = jax.tree.map(lambda a: jax.lax.with_sharding_constraint(a, spec),
                              batched_args)
        out = vmapped(*placed)
        return jax.tree.map(lambda a: jax.lax.with_sharding_constraint(a, spec), out)

    return run


def scenario_rollout_stats(batched_perf) -> dict:
    """Aggregate a batched PerformanceIndex into summary stats (host-side)."""
    cost = np.asarray(batched_perf.cost)
    return {
        "num": int(cost.shape[0]),
        "cost_mean": float(cost.mean()),
        "cost_p99": float(np.percentile(cost, 99)),
    }
