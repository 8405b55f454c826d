"""Smoke run of the main path on one NVIDIA GPU, through the user entry points.

Phases, each printing its own line before the last:
  device     JAX devices, JAX version, matmul precision, nvidia-smi name and
             power limit.  Exits non-zero unless JAX's platform is "gpu".
  flagship   legged robot (ANYmal centroidal, nx=nu=24), trot, T=1 s, N=100,
             SQP rk2 10 iterations: a dependent chain of receding-horizon
             ticks, every tick finite, the first tick repeated on the CPU.
  runtime    ballbot Mpc + MpcMrtInterface + dummy_loop (MPC <-> MRT loop).
  batched    ballbot DDP b4096, quadrotor SQP b4096, legged SQP b256.
  riccati    every batched Riccati path the vmap rule can choose, against
             each other and against a float64 dense KKT solve.
The big programs of the flagship and batched phases (and of --four) are
lowered first and then compiled side by side in threads, so the script pays
the slowest compile instead of their sum.
The last line is one JSON object {"ok": true, "device": {...}}.

With --four, only the paths that span four GPUs run (scenario sharding and
horizon-sharded PIPG), each against its single-device counterpart.

Any failed check raises, so the process exits non-zero and prints no result.

Run:  python chip_smoke.py          (one GPU)
      python chip_smoke.py --four   (four GPUs of one host)
"""
import argparse
import json
import subprocess
import time
from concurrent.futures import ThreadPoolExecutor

import jax
import jax.numpy as jnp
import numpy as np

import bench
import ocs2_tpu  # noqa: F401  (sets the matmul precision before any compile)

# Flagship GPU tick vs the same tick on the CPU, relative to the largest
# entry: both are float32 with matmul precision "highest", but XLA sums in
# another order on each backend and autotunes GPU kernels.  On the CPU the
# tick's xs/us move by 2e-7/6e-7 under a 1e-7 relative change of x0, and by
# 2e-7/6e-7 from float32 to float64; the H100 tick differed from the CPU by
# at most 8.7e-7.  float32 products rounded to TF32 (10-bit mantissa, 5e-4)
# would land far above this bound.
TOL_FLAGSHIP_CPU = 1e-5
# Riccati paths against each other (per scenario, relative to the largest
# entry): the same float32 recursion with another summation order.  The
# vmap path multiplies with dot products, the batch-minor path with
# elementwise entry arithmetic, so TF32 dot products would split them.
TOL_RICCATI_PATHS = 1e-4
# Riccati paths against the float64 dense KKT solve: float32 rounding
# accumulated over up to 100 backward steps (1.4e-6 at most on the H100).
TOL_RICCATI_DENSE = 1e-5
# Scenario-sharded legged SQP vs the single-device vmap of the same solve:
# one float32 program, partitioned or not.
TOL_SHARDED = 1e-5
# Four-GPU horizon-sharded PIPG SQP vs the unsharded PIPG SQP: collectives
# change the reduction order inside 4000 PIPG iterations, and 6 SQP
# iterations amplify it.  On a four-device CPU mesh the two differ by 3.1e-4
# in xs and 1.6e-3 in the cost (four H100s: 6.4e-7 and 3.4e-7);
# tests/test_sharding.py holds the CPU mesh to the same bounds.
TOL_PIPG_XS_ABS = 5e-3
TOL_PIPG_COST_REL = 5e-2

def check(ok, msg):
    if not ok:
        raise AssertionError(msg)


def rel_err(x, ref):
    """max |x - ref| / max |ref| (numpy or JAX arrays)."""
    x, ref = np.asarray(x, np.float64), np.asarray(ref, np.float64)
    return float(np.max(np.abs(x - ref)) / max(np.max(np.abs(ref)), 1e-30))


def all_finite(tree):
    return all(bool(jnp.all(jnp.isfinite(x))) for x in jax.tree.leaves(tree))


def compile_side_by_side(jobs):
    """Lower every job {name: (jitted fn, args)}, then compile them all at
    once in threads (XLA compiles with the GIL released).

    Returns {name: (compiled executable, args)}; a failed compile raises."""
    t0 = time.perf_counter()
    lowered = {name: fn.lower(*args) for name, (fn, args) in jobs.items()}
    lower_s = time.perf_counter() - t0
    with ThreadPoolExecutor(max_workers=len(lowered)) as pool:
        futures = {name: pool.submit(low.compile) for name, low in lowered.items()}
        compiled = {name: fut.result() for name, fut in futures.items()}
    print(f"[compile] {', '.join(compiled)}: lowered in {lower_s:.1f} s, "
          f"compiled side by side in {time.perf_counter() - t0 - lower_s:.1f} s",
          flush=True)
    return {name: (compiled[name], jobs[name][1]) for name in jobs}


# -- device ---------------------------------------------------------------------


def nvidia_smi() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60,
    )
    return out.stdout.strip()


def device_phase(count: int = 1):
    devs = jax.devices()
    d = devs[0]
    print(
        f"[device] jax {jax.__version__} devices={devs} platform={d.platform} "
        f"kind={d.device_kind} "
        f"matmul_precision={jax.config.jax_default_matmul_precision}",
        flush=True,
    )
    if d.platform != "gpu":
        raise SystemExit(f"chip_smoke.py needs a GPU; JAX found {d.platform}")
    if len(devs) < count:
        raise SystemExit(f"need {count} GPUs, JAX found {len(devs)}")
    print(f"[device] nvidia-smi: {nvidia_smi()}", flush=True)
    return devs[:count]


# -- flagship -------------------------------------------------------------------


def flagship_jobs(num_intervals=100):
    """The flagship tick on the default device and the same tick on the CPU."""
    tick, x0, us, params = bench.make_legged_tick(num_intervals)
    on_cpu = jax.device_put((x0, us, params), jax.devices("cpu")[0])
    return {"flagship": (jax.jit(tick), (x0, us, params)),
            "flagship_cpu": (jax.jit(tick), on_cpu)}


def flagship_phase(progs, ticks=12):
    solve_tick, (x0, us, params) = progs["flagship"]
    first = jax.block_until_ready(solve_tick(x0, us, params))

    costs, times = [], []
    x, u = x0, us
    for k in range(ticks):
        t0 = time.perf_counter()
        x, u, sol = jax.block_until_ready(solve_tick(x, u, params))
        times.append(time.perf_counter() - t0)
        check(all_finite((x, u, sol.xs, sol.us, sol.performance.cost)),
              f"flagship tick {k} is not finite")
        costs.append(float(sol.performance.cost))
    n = first[1].shape[0]
    print(f"[flagship] N={n} {ticks} chained ticks, costs {costs}, "
          f"median tick {np.median(times) * 1e3:.3f} ms", flush=True)

    cpu_tick, cpu_args = progs["flagship_cpu"]
    ref = cpu_tick(*cpu_args)[2]
    errs = {
        "xs": rel_err(first[2].xs, ref.xs),
        "us": rel_err(first[2].us, ref.us),
        "cost": rel_err(first[2].performance.cost, ref.performance.cost),
    }
    print(f"[flagship] first tick GPU vs CPU relative error "
          f"{errs} (tolerance {TOL_FLAGSHIP_CPU})", flush=True)
    check(max(errs.values()) <= TOL_FLAGSHIP_CPU,
          f"flagship GPU tick disagrees with the CPU tick: {errs}")


# -- runtime API ----------------------------------------------------------------


def runtime_phase(duration=0.1):
    from ocs2_tpu.models import ballbot
    from ocs2_tpu.mpc.mpc import Mpc, MpcSettings
    from ocs2_tpu.mpc.mrt import MpcMrtInterface, dummy_loop
    from ocs2_tpu.solvers import sqp

    mpc = Mpc(
        ballbot.make_problem(), ballbot.make_params(),
        settings=MpcSettings(time_horizon=1.0, num_intervals=20),
        solver_settings=sqp.SqpSettings(max_iterations=10, integrator="rk4"),
    )
    iface = MpcMrtInterface(mpc)
    x0 = jnp.zeros(ballbot.NX).at[3].set(0.05)
    ts, xs, us = dummy_loop(
        iface, x0, duration=duration, mrt_frequency=400.0, mpc_frequency=100.0
    )
    check(all_finite((xs, us)), "runtime loop state is not finite")
    check(mpc.solve_timer.count >= 1, "the MPC never ran")
    print(f"[runtime] ballbot MPC/MRT dummy_loop {len(ts) - 1} MRT steps, "
          f"{mpc.solve_timer.count} MPC ticks, final pitch "
          f"{float(xs[-1, 3]):.5f}", flush=True)


# -- batched solves -------------------------------------------------------------

BATCHED_LANES = (
    ("ballbot DDP b4096", bench.make_ballbot_batch, 4096),
    ("quadrotor SQP b4096", bench.make_quadrotor_batch, 4096),
    ("legged SQP b256", bench.make_legged_batch, 256),
)


def batched_jobs(scale=1):
    """The bench's batched solves; `scale` divides every batch size."""
    return {name: make(batch // scale) for name, make, batch in BATCHED_LANES}


def batched_phase(progs):
    for name, _, _ in BATCHED_LANES:
        solve, args = progs[name]
        xs = jax.block_until_ready(solve(*args))
        t0 = time.perf_counter()
        xs = jax.block_until_ready(solve(*args))
        run_ms = (time.perf_counter() - t0) * 1e3
        check(all_finite(xs), f"{name}: non-finite trajectory")
        print(f"[batched] {name}: xs {tuple(xs.shape)} finite, "
              f"second call {run_ms:.3f} ms", flush=True)


# -- Riccati paths --------------------------------------------------------------


def riccati_paths():
    """The batched paths `_lqr_backward_vmap_rule` can choose, plus the rule
    itself (`vmap(lqr_backward)`)."""
    from ocs2_tpu.ops import riccati

    return {
        "vmap_single": jax.vmap(riccati._lqr_backward_single),
        "batch_minor": riccati._lqr_backward_batched,
        "dispatched": jax.vmap(riccati.lqr_backward),
    }


def riccati_check(cases=bench.RICCATI_CASES, n_dense=3, seed=0):
    """Run every path on every case; returns one result dict per case and
    raises if a path misses a tolerance."""
    from ocs2_tpu.solvers.qp import dense_start_sensitivity

    results = []
    for ci, (nx, nu, n, batch) in enumerate(cases):
        coeffs = bench.random_lq_batch(
            jax.random.PRNGKey(seed + ci), batch, n, nx, nu
        )
        reg = jnp.tile(jnp.asarray([0.0, 1e-6, 1e-2, 1.0]), batch // 4 + 1)
        reg = reg[:batch]
        sols = {
            name: jax.block_until_ready(jax.jit(fn)(coeffs, reg))
            for name, fn in riccati_paths().items()
        }
        for name, sol in sols.items():
            check(all_finite((sol.gains, sol.value_S)),
                  f"riccati {name} {nx, nu, n, batch}: non-finite")

        def per_scenario_err(x, ref):
            ax = tuple(range(1, x.ndim))
            num = jnp.max(jnp.abs(x - ref), axis=ax)
            return float(jnp.max(num / jnp.max(jnp.abs(ref), axis=ax)))

        ref = sols["vmap_single"]
        paths_err = {
            name: max(per_scenario_err(s.gains, ref.gains),
                      per_scenario_err(s.value_S, ref.value_S))
            for name, s in sols.items() if name != "vmap_single"
        }
        dense_err = {name: {"gains": 0.0, "value_S": 0.0} for name in sols}
        for i in np.linspace(0, batch - 1, n_dense).astype(int):
            one = jax.tree.map(lambda x: np.asarray(x[i], np.float64), coeffs)
            one = one._replace(Quu=one.Quu + float(reg[i]) * np.eye(nu))
            dense = dense_start_sensitivity(one)
            for name, s in sols.items():
                e = dense_err[name]
                e["gains"] = max(e["gains"], rel_err(s.gains[i, 0], dense.gains))
                e["value_S"] = max(
                    e["value_S"], rel_err(s.value_S[i, 0], dense.value_S)
                )
        row = {"case": (nx, nu, n, batch), "paths": sorted(sols),
               "vs_vmap_single": paths_err, "vs_dense_f64": dense_err}
        print(f"[riccati] nx={nx} nu={nu} N={n} B={batch} paths {sorted(sols)}; "
              f"max rel err vs vmap_single {paths_err} (tolerance "
              f"{TOL_RICCATI_PATHS}); node-0 gains/value_S rel err vs float64 "
              f"dense KKT on {n_dense} scenarios {dense_err} (tolerance "
              f"{TOL_RICCATI_DENSE})", flush=True)
        check(max(paths_err.values()) <= TOL_RICCATI_PATHS,
              f"Riccati paths disagree at {row['case']}: {paths_err}")
        worst = max(max(e.values()) for e in dense_err.values())
        check(worst <= TOL_RICCATI_DENSE,
              f"Riccati paths miss the dense KKT at {row['case']}: {dense_err}")
        results.append(row)
    return results


# -- four GPUs ------------------------------------------------------------------


def four_jobs(devices, per_device=64):
    """Horizon-sharded PIPG SQP on ballbot and the scenario-sharded legged
    SQP over `devices`, each beside its single-device counterpart."""
    from jax.sharding import Mesh, NamedSharding, PartitionSpec as P

    from ocs2_tpu.models import ballbot
    from ocs2_tpu.oc.time_discretization import uniform_grid
    from ocs2_tpu.parallel.mesh import make_mesh, sharded
    from ocs2_tpu.solvers import sqp

    n_dev = len(devices)
    problem = ballbot.make_problem()
    grid = uniform_grid(0.0, 1.0, 8 * n_dev)
    bparams = ballbot.make_params()
    bx0 = jnp.zeros(ballbot.NX).at[3].set(0.1)
    common = dict(max_iterations=6, integrator="rk4", pipg_iterations=4000,
                  use_feedback_policy=False)
    st_s = sqp.SqpSettings(qp_solver="pipg_sharded",
                           time_mesh=Mesh(np.asarray(devices), ("time",)),
                           **common)
    st_u = sqp.SqpSettings(qp_solver="pipg", **common)

    # The batched phase's legged program (bench.make_legged_batch), once
    # scenario-sharded over the mesh and once on one device.
    single, (x0s, us, params) = bench.make_legged_batch(n_dev * per_device)
    tick = bench.make_legged_tick()[0]
    mesh = make_mesh(devices)
    placed = jax.device_put(x0s, NamedSharding(mesh, P("scenario")))
    return {
        "pipg_sharded": (
            jax.jit(lambda x: sqp.solve(problem, grid, x, bparams, settings=st_s)),
            (bx0,)),
        "pipg": (
            jax.jit(lambda x: sqp.solve(problem, grid, x, bparams, settings=st_u)),
            (bx0,)),
        "legged_sharded": (
            sharded(lambda x: tick(x, us, params)[2].xs, mesh), (placed,)),
        "legged_single": (
            single, jax.device_put((x0s, us, params), devices[0])),
    }


def four_phase(progs, n_dev, per_device):
    run = {name: jax.block_until_ready(fn(*args))
           for name, (fn, args) in progs.items()}

    sol_s, sol_u = run["pipg_sharded"], run["pipg"]
    xs_err = float(np.max(np.abs(np.asarray(sol_s.xs) - np.asarray(sol_u.xs))))
    cost_err = abs(float(sol_s.performance.cost) - float(sol_u.performance.cost))
    cost_err /= abs(float(sol_u.performance.cost))
    print(f"[four] horizon-sharded PIPG SQP ballbot N={8 * n_dev} over "
          f"{n_dev} GPUs: xs on {sorted(d.id for d in sol_s.xs.sharding.device_set)}"
          f"; vs unsharded PIPG max |dxs| {xs_err:.3e} (tolerance "
          f"{TOL_PIPG_XS_ABS}), cost rel err {cost_err:.3e} (tolerance "
          f"{TOL_PIPG_COST_REL})", flush=True)
    check(all_finite(sol_s.xs), "horizon-sharded SQP is not finite")
    check(xs_err <= TOL_PIPG_XS_ABS and cost_err <= TOL_PIPG_COST_REL,
          "horizon-sharded PIPG SQP disagrees with the unsharded solve")

    (placed,) = progs["legged_sharded"][1]
    xs_sh, xs_1 = run["legged_sharded"], run["legged_single"]
    a, b = np.asarray(xs_sh, np.float64), np.asarray(xs_1, np.float64)
    err = float(np.max(np.max(np.abs(a - b), axis=(1, 2))
                       / np.max(np.abs(b), axis=(1, 2))))
    print(f"[four] scenario sharding legged SQP b={n_dev}x{per_device}: "
          f"input on {sorted(d.id for d in placed.sharding.device_set)}, "
          f"output on {sorted(d.id for d in xs_sh.sharding.device_set)}, "
          f"single-device run on "
          f"{sorted(d.id for d in xs_1.sharding.device_set)}; max per-scenario "
          f"rel err vs single-GPU vmap {err:.3e} (tolerance {TOL_SHARDED})",
          flush=True)
    check(len(xs_sh.sharding.device_set) == n_dev, "scenario output not sharded")
    check(all_finite(xs_sh), "sharded legged solve is not finite")
    check(err <= TOL_SHARDED, f"sharded != single-GPU: {err}")


def main(argv=None):
    parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    parser.add_argument("--four", action="store_true",
                        help="run only the four-GPU paths")
    args = parser.parse_args(argv)

    count = 4 if args.four else 1
    devices = device_phase(count)

    from ocs2_tpu.utils.compile_cache import enable_compile_cache

    enable_compile_cache()
    if args.four:
        per_device = 64
        four_phase(compile_side_by_side(four_jobs(devices, per_device)),
                   len(devices), per_device)
    else:
        progs = compile_side_by_side({**flagship_jobs(), **batched_jobs()})
        flagship_phase(progs)
        runtime_phase()
        batched_phase(progs)
        riccati_check()
    d = devices[0]
    print(json.dumps({"ok": True, "device": {
        "platform": d.platform, "kind": d.device_kind,
        "count": len(jax.devices())}}))


if __name__ == "__main__":
    main()
