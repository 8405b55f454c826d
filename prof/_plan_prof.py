import os, sys, time; sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
os.environ.setdefault("XLA_FLAGS", "--xla_force_host_platform_device_count=1")
import jax
jax.config.update("jax_platforms", "cpu")
import jax.numpy as jnp, numpy as np
import cProfile, pstats
from ocs2_tpu.core.reference import TargetTrajectories
from ocs2_tpu.models.legged_robot import model
from ocs2_tpu.models.legged_robot.foothold_planner import plan_footholds
from ocs2_tpu.models.legged_robot.gait import GaitSchedule, trot_gait
from ocs2_tpu.models.legged_robot.segmented_planes import ElevationMap, decompose_planes
from ocs2_tpu.oc.time_discretization import make_time_grid

res, extent, step_x, high = 0.05, 4.0, 0.45, 0.12
m = int(extent / res)
heights = np.zeros((m, m), np.float32)
xs_grid = -extent/2 + (np.arange(m)+0.5)*res
heights[xs_grid > step_x, :] = high
em = ElevationMap.create(heights, origin_xy=(-extent/2, -extent/2), resolution=res)
terr = decompose_planes(em)
gs = GaitSchedule(trot_gait(0.7)); ms = gs.mode_schedule(0.0, 1.4)
grid = make_time_grid(0.0, 1.4, 46, event_times=np.asarray(ms.event_times), mode_sequence=np.asarray(ms.mode_sequence))
x0 = model.default_state()
u0 = model.weight_compensating_input(jnp.ones(4))
tgt = TargetTrajectories.create(times=[0.0,1.4], states=jnp.stack([x0, x0]), inputs=jnp.stack([u0,u0]))
t_np, m_np = np.asarray(grid.times), np.asarray(grid.modes)
x_np = np.asarray(x0)
plan_footholds(terr, em, t_np, m_np, x_np, tgt)  # warm
tic=time.perf_counter()
for _ in range(5): plan_footholds(terr, em, t_np, m_np, x_np, tgt)
print("plan ms", (time.perf_counter()-tic)/5*1e3)
pr = cProfile.Profile(); pr.enable()
for _ in range(5): plan_footholds(terr, em, t_np, m_np, x_np, tgt)
pr.disable()
pstats.Stats(pr).sort_stats("cumulative").print_stats(12)
