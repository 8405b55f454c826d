"""Flagship (single-scenario legged MPC) experiments on one GPU.

Measures warm receding-horizon tick chains (the bench methodology) for:
  * parallel_riccati off/on at several horizon lengths,
  * max_iterations sweep (marginal per-iteration cost).

Run:  python prof/flagship_sweep.py [nsweep|iters]
"""
import json
import os
import sys
import time

import numpy as np

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

import ocs2_tpu  # noqa: E402,F401
from ocs2_tpu.utils.compile_cache import enable_compile_cache  # noqa: E402


def make_solver(num_intervals, parallel_riccati, max_iterations=10):
    from ocs2_tpu.models.legged_robot import interface, model
    from ocs2_tpu.models.legged_robot.gait import GaitSchedule, trot_gait
    from ocs2_tpu.oc.time_discretization import make_time_grid
    from ocs2_tpu.solvers import sqp

    horizon = 1.0
    problem = interface.make_problem()
    gs = GaitSchedule(trot_gait(0.7))
    ms = gs.mode_schedule(0.0, horizon)
    grid = make_time_grid(
        0.0, horizon, num_intervals,
        event_times=np.asarray(ms.event_times),
        mode_sequence=np.asarray(ms.mode_sequence),
    )
    params = jax.device_put(interface.make_params(grid))
    settings = sqp.SqpSettings(
        max_iterations=max_iterations,
        integrator="rk2",
        parallel_riccati=parallel_riccati,
    )

    @jax.jit
    def solve_tick(x0, us_warm, params):
        sol = sqp.solve(
            problem, grid, x0, params, us_init=us_warm, settings=settings
        )
        return sol.xs[1], sol.us, sol.xs

    u0 = model.weight_compensating_input(jnp.ones(4))
    us_init = jnp.tile(u0[None], (num_intervals, 1))
    return solve_tick, model.default_state(), us_init, params


def chain_time(solve_tick, x0, us_init, params, seg=8, chains=8):
    x, us = x0, us_init
    out = solve_tick(x, us, params)
    jax.block_until_ready(out)
    per = []
    for _ in range(chains):
        tic = time.perf_counter()
        for _ in range(seg):
            x, us, xs = solve_tick(x, us, params)
        jax.block_until_ready(xs)
        per.append((time.perf_counter() - tic) / seg)
    return float(np.mean(per[1:])), float(np.percentile(per[1:], 99))


def nsweep(only_n=None, only_par=None):
    for n in (100, 400, 1000):
        if only_n is not None and n != only_n:
            continue
        for par in (False, True):
            if only_par is not None and par != only_par:
                continue
            solve_tick, x0, us_init, params = make_solver(n, par)
            mean, p99 = chain_time(solve_tick, x0, us_init, params)
            print(
                json.dumps(
                    {
                        "N": n,
                        "parallel_riccati": par,
                        "ms_per_solve": round(mean * 1e3, 2),
                        "p99_ms": round(p99 * 1e3, 2),
                    }
                ),
                flush=True,
            )


def iters():
    for it in (1, 2, 4, 10):
        solve_tick, x0, us_init, params = make_solver(100, False, it)
        mean, _ = chain_time(solve_tick, x0, us_init, params)
        print(
            json.dumps({"max_iterations": it, "ms_per_solve": round(mean * 1e3, 2)}),
            flush=True,
        )


if __name__ == "__main__":
    enable_compile_cache()
    which = sys.argv[1] if len(sys.argv) > 1 else "nsweep"
    if which == "nsweep":
        only_n = int(sys.argv[2]) if len(sys.argv) > 2 else None
        only_par = (
            sys.argv[3] == "par" if len(sys.argv) > 3 else None
        )
        nsweep(only_n, only_par)
    else:
        iters()
