"""The reference's configured 10-instance NonnegPCA sweep, end-to-end.

The reference runs this sweep as 10 independent Hydra-multirun OS
processes (dataset sweeper ``instance_name: 1..10`` at
``/root/reference/src/NonnegPCA/config_dataset.yaml:22-26``, then one
simulation process per instance).  Here the whole sweep is ONE compiled
vmapped solve: instance matrices Z are a traced batch axis through
``parallel.sweep.instance_batched_riptrm``, so 10 instances x their
initial points solve together on one device.

    python -m riptrm_tpu.experiment.paper_sweep            # default device
    python -m riptrm_tpu.experiment.paper_sweep --cpu      # x64 CPU

Produces:
  result/NonnegPCA_instance_sweep.json  (per-instance final residuals)
  result/NonnegPCA_instance_boxplot.png (analyzer-style log10 box plot)

Missing dataset instances are generated first with the same seeds the
``generate`` CLI uses (identical CSVs on disk).
"""

from __future__ import annotations

import argparse
import json
import os
import time

import numpy as np

RESULT_DIR = "result"
N_INSTANCES = 10
INITIALPOINTS = ("a",)  # the reference's configured list


def ensure_instances():
    """Generate dataset/NonnegPCA/{1..10} where missing (same seeds as
    ``generate --problem NonnegPCA -m``)."""
    from riptrm_tpu.experiment.generate import main as generate_main

    missing = [
        i
        for i in range(1, N_INSTANCES + 1)
        if not os.path.exists(f"dataset/NonnegPCA/{i}/Z.csv")
    ]
    for i in missing:
        generate_main(["--problem", "NonnegPCA", f"instance_name={i}"])
    return missing


def load_batch(dtype):
    """Stack the 10 instances' (Z, x0, y0) along a leading batch axis."""
    import jax.numpy as jnp

    from riptrm_tpu.utils.io import loadtxt

    zs, xs, ys, labels = [], [], [], []
    for i in range(1, N_INSTANCES + 1):
        d = f"dataset/NonnegPCA/{i}"
        dim = int(np.atleast_1d(loadtxt(f"{d}/dim.csv"))[0])
        z = loadtxt(f"{d}/Z.csv").reshape(dim, dim)
        for pt in INITIALPOINTS:
            zs.append(z)
            xs.append(loadtxt(f"{d}/initx_{pt}.csv").reshape(dim))
            ys.append(np.atleast_1d(loadtxt(f"{d}/initineqLagmult.csv")).reshape(dim))
            labels.append(f"{i}/{pt}")
    return (
        jnp.asarray(np.stack(zs), dtype),
        jnp.asarray(np.stack(xs), dtype),
        jnp.asarray(np.stack(ys), dtype),
        labels,
    )


def main(argv=None):
    parser = argparse.ArgumentParser(description=__doc__)
    parser.add_argument("--cpu", action="store_true",
                        help="x64 CPU instead of the default device "
                             "(reference-tight tolerances)")
    parser.add_argument("--max-steps", type=int, default=2000)
    parser.add_argument("--budget", type=float, default=240.0,
                        help="per-job reference wall budget (s), reported "
                             "against the sweep's actual wall time")
    args = parser.parse_args(argv)

    from riptrm_tpu.config import setup

    jax = setup(cpu=args.cpu, x64=args.cpu)
    import jax.numpy as jnp

    from riptrm_tpu.parallel.sweep import instance_batched_riptrm

    ensure_instances()
    dtype = jnp.float64 if args.cpu else jnp.float32
    zs, xs0, ys0, labels = load_batch(dtype)

    if args.cpu:
        option = {
            "maxiter": 10_000,
            "tolresid": 1e-15,
            "TRS_solver": "tCG",
            "second_order_stationarity": False,
        }
    else:
        option = {
            "maxiter": 10_000,
            "tolresid": 2e-4,
            "TRS_solver": "tCG",
            "second_order_stationarity": False,
            # f32 floors (the reference's 1e-14 floors assume f64)
            "forcing_function_Lagrangian": lambda mu: jnp.maximum(mu, 1e-4),
            "forcing_function_complementarity": (
                lambda mu: jnp.maximum(1e-3 * mu, 2e-4)
            ),
        }
        jax.config.update("jax_default_matmul_precision", "high")

    solve = instance_batched_riptrm(option, max_steps=args.max_steps)
    t0 = time.time()
    x_fin, y_fin, ks, res = solve(zs, xs0, ys0)
    res = np.asarray(res, float)
    ks = np.asarray(ks, int)
    wall = time.time() - t0  # includes the single compile

    t1 = time.time()
    x_fin, y_fin, ks2, res2 = solve(zs, xs0, ys0)
    np.asarray(res2)
    solve_wall = time.time() - t1

    os.makedirs(RESULT_DIR, exist_ok=True)
    out = {
        "problem": "NonnegPCA",
        "instances": N_INSTANCES,
        "initialpoints": list(INITIALPOINTS),
        "device": str(jax.devices()[0]),
        "dtype": str(dtype.__name__ if hasattr(dtype, "__name__") else dtype),
        "jobs": {lab: {"residual": float(r), "steps": int(k)}
                 for lab, r, k in zip(labels, res, ks)},
        "median_residual": float(np.median(res)),
        "max_residual": float(np.max(res)),
        "compile_plus_solve_s": round(wall, 2),
        "solve_s": round(solve_wall, 2),
        "reference_budget_s": args.budget * len(labels),
    }
    with open(f"{RESULT_DIR}/NonnegPCA_instance_sweep.json", "w") as f:
        json.dump(out, f, indent=1)

    # analyzer-style box plot of log10 final residuals over instances
    import matplotlib

    matplotlib.use("Agg")
    import matplotlib.pyplot as plt

    fig, ax = plt.subplots(figsize=(4.5, 4))
    ax.boxplot([np.log10(np.maximum(res, 1e-300))],
               tick_labels=["RIPTRM (tCG, batched)"])
    ax.set_ylabel("log10 final KKT residual")
    ax.set_title(f"NonnegPCA 10-instance sweep ({out['device']})")
    fig.tight_layout()
    fig.savefig(f"{RESULT_DIR}/NonnegPCA_instance_boxplot.png", dpi=150)

    print(json.dumps({
        "jobs": len(labels),
        "median_residual": out["median_residual"],
        "max_residual": out["max_residual"],
        "solve_s": out["solve_s"],
        "vs_reference_budget": round(
            out["solve_s"] / out["reference_budget_s"], 5
        ),
        "device": out["device"],
    }))


if __name__ == "__main__":
    main()
