"""MPC-Net: policy learning by imitating the MPC through its Hamiltonian.

JAX-native re-design of the reference MPC-Net pipeline (ocs2_mpcnet):
* MpcnetRolloutManager's nDataGen/nPolicyEval worker threads, each owning an
  MPC + ONNX policy (rollout/MpcnetRolloutManager.h:43-133)  ->  ONE vmapped
  closed-loop scan: scenarios are a batch axis, the MPC solve *is* the
  jitted SQP solve, and the learned policy runs in the same XLA program
  (no ONNX boundary, control/MpcnetOnnxController.h:59 disappears).
* MpcnetBehavioralController (alpha * MPC + (1-alpha) * policy mixing,
  control/MpcnetBehavioralController.h)  ->  a lax blend inside the scan.
* Data harvesting of (t, x, u*, Hamiltonian quadratic approximation)
  (rollout/MpcnetDataGeneration.h:42, rollout/MpcnetData.h)  ->  the
  Q-function expansion assembled from solver byproducts (loss.py).
* Training loop (python/ocs2_mpcnet_core/mpcnet.py:177-260: async data gen
  -> replay memory -> batched loss -> Adam, alpha annealed 1 -> 0)  ->  the
  same loop with optax.adam and a jittable CircularMemory.
* Policy evaluation metrics: survival time and incurred Hamiltonian
  (rollout/MpcnetPolicyEvaluation.h:42, rollout/MpcnetMetrics.h).
"""
from __future__ import annotations

import dataclasses
from typing import Any, Callable, NamedTuple, Optional

import jax
import jax.numpy as jnp
import optax

from ..core.integrate import discretize
from ..oc.approx import approximate_lq
from ..oc.problem import OptimalControlProblem
from ..oc.time_discretization import TimeGrid
from ..solvers import sqp as sqp_mod
from .loss import HamiltonianApprox, hamiltonian_from_lq, hamiltonian_loss
from .memory import CircularMemory

Array = jax.Array


class MpcnetSample(NamedTuple):
    """One harvested data point (reference rollout/MpcnetData.h DataPoint)."""

    t: Array  # []
    x: Array  # [nx]
    u_star: Array  # [nu]  MPC-optimal input
    h0: Array  # []
    hu: Array  # [nu]
    Huu: Array  # [nu, nu]


@dataclasses.dataclass(frozen=True)
class MpcnetSettings:
    """Analogue of the reference YAML config (ocs2_mpcnet_core config.py)."""

    rollout_steps: int = 10  # control steps per scenario rollout
    control_dt: float = 0.1
    batch_size: int = 32
    learning_rate: float = 1e-3
    learning_iterations: int = 100
    memory_capacity: int = 4096
    data_scenarios: int = 8  # parallel closed-loop scenarios per round
    rounds: int = 10  # alpha anneals 1 -> 0 over the rounds
    mpc_horizon: float = 1.0
    mpc_intervals: int = 20
    solver_settings: sqp_mod.SqpSettings = sqp_mod.SqpSettings(max_iterations=5)
    # Divergence threshold on |x| for survival-time metric.
    x_max: float = 1e3


def uniform_grid_fn(horizon: float, num_intervals: int) -> Callable[[Array], TimeGrid]:
    """Jittable moving-horizon grid for event-free problems."""
    offsets = jnp.linspace(0.0, horizon, num_intervals + 1)

    def fn(t0: Array) -> TimeGrid:
        return TimeGrid(
            times=t0 + offsets,
            is_jump=jnp.zeros((num_intervals,), offsets.dtype),
            modes=jnp.zeros((num_intervals + 1,), jnp.int32),
        )

    return fn


class Mpcnet:
    """The reference Mpcnet trainer (mpcnet.py:177) as a jitted-step loop."""

    def __init__(
        self,
        problem: OptimalControlProblem,
        params: dict,
        policy_module,
        observation_fn: Callable[[Array, Array], Array] = lambda t, x: x,
        action_transform: Optional[Callable[[Array, Array, Array], Array]] = None,
        settings: MpcnetSettings = MpcnetSettings(),
        grid_fn: Optional[Callable[[Array], TimeGrid]] = None,
    ):
        self.problem = problem
        self.params = dict(params)
        self.module = policy_module
        self.observation_fn = observation_fn
        self.action_transform = action_transform
        self.s = settings
        self.grid_fn = grid_fn or uniform_grid_fn(
            settings.mpc_horizon, settings.mpc_intervals
        )
        self.optimizer = optax.adam(settings.learning_rate)

    # -- policy ------------------------------------------------------------
    def policy_u(self, net_params, t, x):
        a = self.module.apply(net_params, self.observation_fn(t, x))
        if self.action_transform is not None:
            return self.action_transform(t, x, a)
        return a

    def init_policy(self, key, example_x):
        obs = self.observation_fn(jnp.zeros(()), example_x)
        return self.module.init(key, obs)

    # -- data generation ----------------------------------------------------
    def _mpc_step(self, t, x):
        """One MPC solve; returns (u*, Hamiltonian approx at node 0)."""
        grid = self.grid_fn(t)
        sol = sqp_mod.solve(
            self.problem, grid, x, self.params, settings=self.s.solver_settings
        )
        lq = approximate_lq(
            self.problem, grid, sol.xs, sol.us, self.params,
            method=self.s.solver_settings.integrator,
            substeps=self.s.solver_settings.substeps,
        )
        hammy = hamiltonian_from_lq(lq, sol.value_S, sol.value_s, sol.xs)
        return sol.us[0], HamiltonianApprox(
            h0=hammy.h0[0], hu=hammy.hu[0], Huu=hammy.Huu[0]
        )

    def rollout_scenario(self, net_params, alpha, t0, x0) -> MpcnetSample:
        """Closed-loop behavioral rollout harvesting one sample per step
        (MpcnetDataGeneration::run).  Returns stacked samples [steps, ...]."""
        flow = discretize(
            lambda tt, xx, uu: self.problem.dynamics(tt, xx, uu, self.params),
            "rk4", 2,
        )

        def body(carry, _):
            t, x = carry
            u_star, hammy = self._mpc_step(t, x)
            u_pol = self.policy_u(net_params, t, x)
            u = alpha * u_star + (1.0 - alpha) * u_pol
            x_next = flow(t, x, u, self.s.control_dt)
            sample = MpcnetSample(
                t=t, x=x, u_star=u_star, h0=hammy.h0, hu=hammy.hu, Huu=hammy.Huu
            )
            return (t + self.s.control_dt, x_next), sample

        _, samples = jax.lax.scan(
            body, (t0, x0), None, length=self.s.rollout_steps
        )
        return samples

    def generate_data(self, net_params, alpha, t0s, x0s) -> MpcnetSample:
        """vmapped scenario batch (the reference's data-gen worker pool)."""
        samples = jax.vmap(
            lambda t0, x0: self.rollout_scenario(net_params, alpha, t0, x0)
        )(t0s, x0s)
        # Flatten [S, steps, ...] -> [S*steps, ...].
        return jax.tree.map(
            lambda a: a.reshape((-1,) + a.shape[2:]), samples
        )

    # -- training -----------------------------------------------------------
    def loss_fn(self, net_params, batch: MpcnetSample) -> Array:
        u_pred = jax.vmap(lambda t, x: self.policy_u(net_params, t, x))(
            batch.t, batch.x
        )
        hammy = HamiltonianApprox(h0=batch.h0, hu=batch.hu, Huu=batch.Huu)
        return hamiltonian_loss(hammy, u_pred, batch.u_star)

    def train_step(self, net_params, opt_state, memory: CircularMemory, key):
        batch = memory.sample(key, self.s.batch_size)
        loss, grads = jax.value_and_grad(self.loss_fn)(net_params, batch)
        updates, opt_state = self.optimizer.update(grads, opt_state, net_params)
        return optax.apply_updates(net_params, updates), opt_state, loss

    def train(self, key, x0_sampler: Callable[[Array, int], Array], verbose=False):
        """Full training loop (reference Mpcnet.train, mpcnet.py:177-260)."""
        key, k0 = jax.random.split(key)
        example_x = x0_sampler(k0, 1)[0]
        net_params = self.init_policy(k0, example_x)
        opt_state = self.optimizer.init(net_params)

        example = MpcnetSample(
            t=jnp.zeros(()),
            x=jnp.zeros_like(example_x),
            u_star=jnp.zeros((self.problem.nu,)),
            h0=jnp.zeros(()),
            hu=jnp.zeros((self.problem.nu,)),
            Huu=jnp.zeros((self.problem.nu, self.problem.nu)),
        )
        memory = CircularMemory.create(example, self.s.memory_capacity)

        gen = jax.jit(self.generate_data)
        step = jax.jit(self.train_step)
        push = jax.jit(lambda mem, s: mem.push_batch(s))

        losses = []
        for rnd in range(self.s.rounds):
            alpha = 1.0 - rnd / max(self.s.rounds - 1, 1)
            key, kx, kt = jax.random.split(key, 3)
            x0s = x0_sampler(kx, self.s.data_scenarios)
            t0s = jnp.zeros((self.s.data_scenarios,))
            samples = gen(net_params, jnp.asarray(alpha), t0s, x0s)
            memory = push(memory, samples)
            for _ in range(self.s.learning_iterations):
                key, kb = jax.random.split(key)
                net_params, opt_state, loss = step(
                    net_params, opt_state, memory, kb
                )
            losses.append(float(loss))
            if verbose:
                print(f"round {rnd}: alpha={alpha:.2f} loss={float(loss):.4f}")
        return net_params, losses

    # -- evaluation -----------------------------------------------------------
    def evaluate(self, net_params, t0, x0, steps: Optional[int] = None):
        """Pure-policy rollout metrics: survival time + incurred Hamiltonian
        (MpcnetPolicyEvaluation::run, rollout/MpcnetMetrics.h)."""
        steps = steps or self.s.rollout_steps
        flow = discretize(
            lambda tt, xx, uu: self.problem.dynamics(tt, xx, uu, self.params),
            "rk4", 2,
        )

        def body(carry, _):
            t, x, alive, incurred = carry
            u_star, hammy = self._mpc_step(t, x)
            u = self.policy_u(net_params, t, x)
            incurred = incurred + alive * hammy.value(u - u_star)
            x_next = flow(t, x, u, self.s.control_dt)
            ok = jnp.logical_and(
                jnp.all(jnp.isfinite(x_next)),
                jnp.max(jnp.abs(x_next)) < self.s.x_max,
            )
            alive_next = alive * ok.astype(x.dtype)
            x_next = jnp.where(ok, x_next, x)
            return (t + self.s.control_dt, x_next, alive_next, incurred), alive

        (_, _, _, incurred), alive_hist = jax.lax.scan(
            body, (t0, x0, jnp.ones(()), jnp.zeros(())), None, length=steps
        )
        survival_time = jnp.sum(alive_hist) * self.s.control_dt
        return {"survival_time": survival_time, "incurred_hamiltonian": incurred}
