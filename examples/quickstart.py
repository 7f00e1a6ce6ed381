"""Quickstart: solve the shipped NonnegPCA instance with all four solvers.

Run from the repo root:

    python examples/quickstart.py
"""

import os
import sys

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

import riptrm_tpu.config

# Parity runs use CPU + float64 (reference tolerances reach 1e-16).
# On a GPU drop cpu=True (the H100 runs float64 natively); batched
# throughput sweeps build problems in float32.
riptrm_tpu.config.setup(cpu=True, x64=True)

import jax.numpy as jnp  # noqa: E402

from riptrm_tpu.problems import nonneg_pca  # noqa: E402
from riptrm_tpu.solvers import RALM, RIPM, RIPTRM, RSQO  # noqa: E402

problem = nonneg_pca.load_problem("dataset/NonnegPCA/1", "a")
common = {"maxtime": 30, "maxiter": 200, "tolresid": 1e-10, "verbosity": 0}

for solver in (
    RIPTRM(common | {"TRS_solver": "tCG", "second_order_stationarity": False}),
    RIPTRM(common | {"TRS_solver": "Exact_RepMat", "second_order_stationarity": True}),
    RIPM(common | {"checkNTequation": True}),
    RSQO(common | {"quadoptim_eigvalcorr": 1e-2}),
    RALM(common | {"maxiter": 20, "tolresid": 1e-4}),
):
    out = solver.run(problem)
    print(
        f"{out.name:45s} final cost {out.log['cost'][-1]:+.6f} "
        f"KKT residual {out.log['residual'][-1]:.2e} "
        f"({len(out.log['iteration'])} log rows)"
    )

# ----------------------------------------------------------------------
# Batched multi-start sweep (one compiled solve, vmapped over lanes)
# ----------------------------------------------------------------------
import jax  # noqa: E402
import numpy as np  # noqa: E402

from riptrm_tpu.parallel.sweep import batched_solver_sweep  # noqa: E402

B = 8
xs = np.abs(np.asarray(jax.random.normal(jax.random.PRNGKey(0), (B, 50))))
xs /= np.linalg.norm(xs, axis=1, keepdims=True)
ys = np.ones((B, 50))
sweep = batched_solver_sweep(
    problem,
    "RIPTRM",
    {"maxiter": 40, "tolresid": 1e-8, "TRS_solver": "tCG", "second_order_stationarity": False},
    max_steps=600,
)
x_fin, y_fin, steps, residuals = sweep(jnp.asarray(xs), jnp.asarray(ys))
print(f"\nbatched sweep over {B} starts: residuals {np.asarray(residuals)}")
