"""The batched Riccati backward pass on one GPU: the two XLA paths the vmap
rule chooses between (plain vmap of the scan, and the batch-minor entry
form), each alone at the widths of the batched solves.  With --triton it
also times the unused Pallas/Triton kernel in prof/riccati_triton.py (its
compile took 804.9 s per shape on an H100).

Run:  python prof/riccati_ab.py [--triton]
"""
import argparse
import json
import os
import subprocess
import sys

import numpy as np

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

import bench  # noqa: E402
import ocs2_tpu  # noqa: E402,F401  (sets the matmul precision)
from ocs2_tpu.ops import riccati  # noqa: E402
from ocs2_tpu.utils.compile_cache import enable_compile_cache  # noqa: E402


def main():
    parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    parser.add_argument("--triton", action="store_true",
                        help="also time prof/riccati_triton.py's kernel")
    args = parser.parse_args()

    enable_compile_cache()
    dev = jax.devices()[0]
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True,
    ).stdout.strip()
    print(json.dumps({"platform": dev.platform, "device_kind": dev.device_kind,
                      "nvidia_smi": smi}), flush=True)
    paths = {
        "batch_minor": jax.jit(riccati._lqr_backward_batched),
        "vmap_single": jax.jit(jax.vmap(riccati._lqr_backward_single)),
    }
    if args.triton:
        from riccati_triton import lqr_backward_pallas

        paths["triton"] = jax.jit(lqr_backward_pallas)
    for nx, nu, n, batch in bench.RICCATI_CASES:
        coeffs = bench.random_lq_batch(jax.random.PRNGKey(0), batch, n, nx, nu)
        reg = jnp.full((batch,), 1e-6)
        for name, fn in paths.items():
            ms = float(np.median(bench._timeit(fn, coeffs, reg)) * 1e3)
            print(json.dumps({"case": [nx, nu, n, batch], "path": name,
                              "median_ms": ms}), flush=True)


if __name__ == "__main__":
    main()
