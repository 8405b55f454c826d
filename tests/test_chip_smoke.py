"""chip_smoke.py on the CPU: it refuses to run without a GPU, and its
Riccati check (every batched path against each other and against the float64
dense KKT solve) passes at small shapes."""
import pytest

import bench
import chip_smoke


def test_device_phase_exits_nonzero_without_gpu(capsys):
    with pytest.raises(SystemExit) as exc:
        chip_smoke.device_phase()
    assert exc.value.code not in (0, None)
    assert '"ok"' not in capsys.readouterr().out


@pytest.mark.parametrize(
    "case",
    [(10, 3, 8, 1024), (12, 4, 6, 64), (24, 24, 10, 8)],
    ids=["ballbot-widths", "quadrotor-widths", "legged-widths"],
)
def test_riccati_check_passes_at_small_shapes(case):
    (row,) = chip_smoke.riccati_check(cases=(case,), n_dense=2)
    assert {"vmap_single", "batch_minor", "dispatched"} <= set(row["paths"])
    assert max(row["vs_vmap_single"].values()) <= chip_smoke.TOL_RICCATI_PATHS


@pytest.mark.gpu
def test_riccati_check_on_gpu(gpu_device):
    """The full-width Riccati check of chip_smoke.py, as a GPU test."""
    rows = chip_smoke.riccati_check()
    assert len(rows) == len(bench.RICCATI_CASES)
