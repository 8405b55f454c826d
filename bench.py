"""Benchmarks on one GPU.

Primary metric (vs_baseline): legged-robot MPC solves/s at N=100 horizon
against the reference's 50 Hz real-time target (BASELINE.md: legged-robot
task.info mpcDesiredFrequency, 20 ms budget/solve).

Additional metrics (BASELINE.json):
* batched DDP/SLQ solves/s at batch 4096 on ballbot,
* quadrotor 4096-scenario batched SQP solves/s,
* legged-robot batched SQP throughput (b=256),
* perceptive legged MPC ticks/s with host foothold planning in the loop.

The legged MPC metric times chains of data-dependent solves: each tick's
initial state and warm start come from the previous solution, the
receding-horizon dependency structure.  Every timing ends in
`jax.block_until_ready`.

Prints ONE JSON line {"metric", "value", "unit", "vs_baseline", ...} with
the device it ran on.  Exits non-zero when JAX finds no GPU.

Run:  python bench.py
"""
import json
import sys
import time

import numpy as np


def _timeit(fn, *args, reps=20, warmup=2):
    import jax

    lat = []
    for _ in range(warmup):
        jax.block_until_ready(fn(*args))
    for _ in range(reps):
        tic = time.perf_counter()
        jax.block_until_ready(fn(*args))
        lat.append(time.perf_counter() - tic)
    return np.asarray(lat)


# -- problem builders (shared with chip_smoke.py) ------------------------------


def make_legged_tick(num_intervals=100, horizon=1.0):
    """The flagship: ANYmal centroidal trot, SQP rk2, 10 iterations.

    Returns (tick, x0, us_init, params); tick(x0, us_warm, params) solves one
    MPC tick and returns (next x0, solved inputs, solution)."""
    import jax
    import jax.numpy as jnp

    from ocs2_tpu.models.legged_robot import interface, model
    from ocs2_tpu.models.legged_robot.gait import GaitSchedule, trot_gait
    from ocs2_tpu.oc.time_discretization import make_time_grid
    from ocs2_tpu.solvers import sqp

    problem = interface.make_problem()
    gs = GaitSchedule(trot_gait(0.7))
    ms = gs.mode_schedule(0.0, horizon)
    grid = make_time_grid(
        0.0, horizon, num_intervals,
        event_times=np.asarray(ms.event_times),
        mode_sequence=np.asarray(ms.mode_sequence),
    )
    params = jax.device_put(interface.make_params(grid))
    u0 = model.weight_compensating_input(jnp.ones(4))
    us_init = jnp.tile(u0[None], (num_intervals, 1))
    settings = sqp.SqpSettings(max_iterations=10, integrator="rk2")

    def tick(x0, us_warm, params):
        """One MPC tick: solve, then advance one node along the optimized
        trajectory for the next tick's initial state (receding horizon)."""
        sol = sqp.solve(
            problem, grid, x0, params, us_init=us_warm, settings=settings
        )
        return sol.xs[1], sol.us, sol

    return tick, model.default_state(), us_init, params


def make_legged_batch(batch=256):
    """vmap of the flagship tick over perturbed initial states."""
    import jax
    import jax.numpy as jnp

    from ocs2_tpu.models.legged_robot import model

    tick, x0, us_init, params = make_legged_tick()
    x0s = x0[None] + 1e-3 * jnp.sin(
        jnp.arange(batch)[:, None] * jnp.arange(model.NX)[None, :]
    )
    solve = jax.jit(
        jax.vmap(lambda x, u, p: tick(x, u, p)[2].xs, in_axes=(0, None, None))
    )
    return solve, (x0s, us_init, params)


def make_ballbot_batch(batch=4096):
    """Batched iLQR DDP on ballbot, N=32."""
    import jax

    from ocs2_tpu.models import ballbot
    from ocs2_tpu.oc.time_discretization import uniform_grid
    from ocs2_tpu.solvers import ddp

    problem = ballbot.make_problem()
    grid = uniform_grid(0.0, 1.0, 32)
    params = jax.device_put(ballbot.make_params())
    st = ddp.DdpSettings(algorithm="ilqr", max_iterations=8)
    solve = jax.jit(
        jax.vmap(
            lambda x, p: ddp.solve(problem, grid, x, p, settings=st).xs,
            in_axes=(0, None),
        )
    )
    x0s = 0.1 * jax.random.normal(jax.random.PRNGKey(0), (batch, ballbot.NX))
    return solve, (x0s, params)


def make_quadrotor_batch(batch=4096):
    """Batched SQP (rk4) on the quadrotor, N=40 (BASELINE.json scenario)."""
    import jax
    import jax.numpy as jnp

    from ocs2_tpu.models import quadrotor
    from ocs2_tpu.oc.time_discretization import uniform_grid
    from ocs2_tpu.solvers import sqp

    problem = quadrotor.make_problem()
    grid = uniform_grid(0.0, 2.0, 40)
    params = jax.device_put(quadrotor.make_params())
    st = sqp.SqpSettings(max_iterations=8, integrator="rk4")
    solve = jax.jit(
        jax.vmap(
            lambda x, p: sqp.solve(problem, grid, x, p, settings=st).xs,
            in_axes=(0, None),
        )
    )
    x0s = jnp.zeros((batch, quadrotor.NX)).at[:, 2].set(1.0)
    x0s = x0s + 0.05 * jax.random.normal(
        jax.random.PRNGKey(1), (batch, quadrotor.NX)
    )
    return solve, (x0s, params)


# Widths (nx, nu, N, B) of the batched lanes' Riccati backward passes:
# ballbot b4096, quadrotor b4096, legged b256.
RICCATI_CASES = (
    (10, 3, 32, 4096),
    (12, 4, 40, 4096),
    (24, 24, 100, 256),
)


def random_lq_batch(key, batch, n, nx, nu):
    """Well-posed random LQ problems, leaves [B, N, ...] (the recipe of the
    tests' lq_fixtures)."""
    import jax
    import jax.numpy as jnp

    from ocs2_tpu.ops.riccati import LqrCoeffs

    ks = jax.random.split(key, 10)
    nrm = jax.random.normal

    def psd(k, d, eps, lead):
        m = nrm(k, lead + (d, d))
        return m @ jnp.swapaxes(m, -1, -2) / d + eps * jnp.eye(d)

    lead = (batch, n)
    return LqrCoeffs(
        A=nrm(ks[0], lead + (nx, nx)) / np.sqrt(nx) + 0.5 * jnp.eye(nx),
        B=0.5 * nrm(ks[1], lead + (nx, nu)),
        b=0.1 * nrm(ks[2], lead + (nx,)),
        Qxx=psd(ks[3], nx, 0.2, lead),
        qx=nrm(ks[4], lead + (nx,)),
        Quu=psd(ks[5], nu, 0.5, lead),
        qu=nrm(ks[6], lead + (nu,)),
        Qux=0.05 * nrm(ks[7], lead + (nu, nx)),
        Qf=psd(ks[8], nx, 0.3, (batch,)),
        qf=nrm(ks[9], (batch, nx)),
    )


# -- lanes ---------------------------------------------------------------------


def bench_legged_mpc():
    import jax

    tick, x0, us_init, params = make_legged_tick()
    solve_tick = jax.jit(tick)
    jax.block_until_ready(solve_tick(x0, us_init, params))  # compile

    # Dependent-chain latency: chains of `seg` receding-horizon ticks;
    # per-solve latency = chain time / seg.
    seg, chains = 8, 12
    per_solve = []
    x, us = x0, us_init
    for _ in range(chains):
        tic = time.perf_counter()
        for _ in range(seg):
            x, us, sol = solve_tick(x, us, params)
        jax.block_until_ready(sol)
        per_solve.append((time.perf_counter() - tic) / seg)
    lat = np.asarray(per_solve)

    bsolve, bargs = make_legged_batch(256)
    blat = _timeit(bsolve, *bargs, reps=3)
    return {
        "solves_per_s": 1.0 / lat.mean(),
        "p50_ms": float(np.percentile(lat, 50) * 1e3),
        "p99_ms": float(np.percentile(lat, 99) * 1e3),
        "batched_solves_per_s_b256": 256 / blat.mean(),
    }


def bench_batched_ddp_ballbot(batch=4096):
    solve, args = make_ballbot_batch(batch)
    return batch / _timeit(solve, *args, reps=5).mean()


def bench_batched_quadrotor(batch=4096):
    solve, args = make_quadrotor_batch(batch)
    return batch / _timeit(solve, *args, reps=3).mean()


def bench_perceptive_mpc(ticks=20):
    """Perceptive MPC lane: HOST foothold planning (segmented planes) + the
    solve, per tick — the cost the reference pays inside its 20 ms budget
    (SwingTrajectoryPlanner::updateSwingMotions + solve).  Reports ticks/s
    with planning included and the host-planning share."""
    import jax
    import jax.numpy as jnp

    from ocs2_tpu.core.reference import TargetTrajectories
    from ocs2_tpu.models.legged_robot import model
    from ocs2_tpu.models.legged_robot.foothold_planner import (
        make_perceptive_params,
        make_segmented_perceptive_problem,
        plan_footholds,
        plan_to_params,
    )
    from ocs2_tpu.models.legged_robot.gait import GaitSchedule, trot_gait
    from ocs2_tpu.models.legged_robot.segmented_planes import (
        ElevationMap,
        decompose_planes,
    )
    from ocs2_tpu.oc.time_discretization import make_time_grid
    from ocs2_tpu.solvers import sqp

    # Stepped terrain (the test fixture's shape, built inline).
    res, extent, step_x, high = 0.05, 4.0, 0.45, 0.12
    m = int(extent / res)
    heights = np.zeros((m, m), np.float32)
    xs_grid = -extent / 2 + (np.arange(m) + 0.5) * res
    heights[xs_grid > step_x, :] = high
    em = ElevationMap.create(
        heights, origin_xy=(-extent / 2, -extent / 2), resolution=res
    )
    terr = decompose_planes(em)

    horizon, n = 1.4, 46
    gs = GaitSchedule(trot_gait(0.7))
    ms = gs.mode_schedule(0.0, horizon)
    grid = make_time_grid(
        0.0, horizon, n,
        event_times=np.asarray(ms.event_times),
        mode_sequence=np.asarray(ms.mode_sequence),
    )
    x0 = model.default_state()
    u0 = model.weight_compensating_input(jnp.ones(4))
    x_goal = x0.at[6].set(0.85).at[8].set(model.STAND_HEIGHT + high)
    target = TargetTrajectories.create(
        times=[0.0, horizon],
        states=jnp.stack([x0.at[0].set(0.6), x_goal.at[0].set(0.6)]),
        inputs=jnp.stack([u0, u0]),
    )
    problem = make_segmented_perceptive_problem()
    params = make_perceptive_params(grid, terr, em, x0, target)
    st = sqp.SqpSettings(max_iterations=8, integrator="rk2")

    @jax.jit
    def solve_tick(x, us_warm, p):
        sol = sqp.solve(problem, grid, x, p, us_init=us_warm, settings=st)
        return sol.xs[1], sol.us, sol.xs

    us = jnp.tile(u0[None], (n, 1))
    jax.block_until_ready(solve_tick(x0, us, jax.device_put(params)))

    x = x0
    plan_t = 0.0
    tic_all = time.perf_counter()
    for _ in range(ticks):
        tic = time.perf_counter()
        # Host re-plan on the CURRENT state (PerceptiveReferenceManager).
        plan = plan_footholds(
            terr, em, np.asarray(grid.times), np.asarray(grid.modes),
            np.asarray(x), target,
        )
        p = jax.device_put(plan_to_params(plan, params))
        plan_t += time.perf_counter() - tic
        x, us, xs_full = solve_tick(x, us, p)
    jax.block_until_ready(xs_full)
    total_t = time.perf_counter() - tic_all
    return {
        "ticks_per_s": ticks / total_t,
        "host_plan_ms": plan_t / ticks * 1e3,
    }


def main():
    import jax

    import ocs2_tpu  # noqa: F401  (sets the matmul precision)
    from ocs2_tpu.utils.compile_cache import enable_compile_cache

    dev = jax.devices()[0]
    if dev.platform != "gpu":
        print(f"bench.py needs a GPU; JAX found {dev.platform}", file=sys.stderr)
        sys.exit(1)
    enable_compile_cache()

    legged = bench_legged_mpc()
    ballbot_ps = bench_batched_ddp_ballbot()
    quad_ps = bench_batched_quadrotor()
    perceptive = bench_perceptive_mpc()

    print(
        json.dumps(
            {
                "metric": "legged_robot_mpc_solves_per_s_N100",
                "value": float(legged["solves_per_s"]),
                "unit": "solves/s",
                "vs_baseline": float(legged["solves_per_s"]) / 50.0,
                "platform": dev.platform,
                "device_kind": dev.device_kind,
                "device_count": len(jax.devices()),
                "p50_ms": legged["p50_ms"],
                "p99_ms": legged["p99_ms"],
                "batched_solves_per_s_b256": float(
                    legged["batched_solves_per_s_b256"]
                ),
                "ballbot_ddp_batched_solves_per_s_b4096": float(ballbot_ps),
                "quadrotor_sqp_batched_solves_per_s_b4096": float(quad_ps),
                "perceptive_mpc_ticks_per_s": float(perceptive["ticks_per_s"]),
                "perceptive_host_plan_ms": float(perceptive["host_plan_ms"]),
            }
        )
    )


if __name__ == "__main__":
    main()
