"""Weak-scaling sweep-efficiency harness.

BASELINE.json's north star asks for "iterations/s efficiency measured at
1 chip, 1 host, and N>=2 hosts" with ">=80% scaling efficiency to 2 hosts".
The reference has no distributed backend to compare against (SURVEY.md
§2.3) — its scale-out is Hydra multirun forking one OS process per job —
so the measured quantity here is the in-process equivalent: batched
multi-start RIPTRM solves (the multirun sweep axes) sharded over a ``dp``
mesh axis with ``shard_map``.

Weak scaling: the per-device batch is FIXED and the device count grows, so
ideal scaling is throughput proportional to devices:

    efficiency(d) = solves_per_sec(d) / (d * solves_per_sec(1))

Timing: the sharded sweep is compiled first, then timed on the host clock
around ``block_until_ready`` (median over ``reps`` calls).

On real hardware run one process per host under ``jax.distributed`` (see
``parallel.distributed.initialize``) and pass the global device list; on a
dev box it validates on a virtual CPU mesh:

    python -m riptrm_tpu.experiment.scaling --cpu --virtual-devices 8
"""

from __future__ import annotations

import json
import sys
import time

import numpy as np


def sweep_rate(problem, option, mesh, batch, max_steps, reps=3):
    """Throughput (solves/s) of the sharded multi-start sweep on ``mesh``.

    The sweep is compiled first, then timed on the host clock over
    ``reps`` calls that each end in ``block_until_ready`` (median).
    Returns (solves_per_sec, median_residual, max_residual).
    """
    import jax
    import jax.numpy as jnp

    from riptrm_tpu.parallel.sweep import sharded_riptrm_solve

    dtype = jnp.asarray(problem.x0).dtype
    n = problem.x0.shape[0]
    key = jax.random.PRNGKey(11)
    xs0 = jnp.abs(jax.random.normal(key, (batch, n), dtype=dtype))
    xs0 = xs0 / jnp.linalg.norm(xs0, axis=1, keepdims=True)
    ys0 = jnp.ones((batch, problem.num_ineq), dtype=dtype)

    fn = sharded_riptrm_solve(problem, option, max_steps, mesh)
    compiled = fn.lower(xs0, ys0).compile()
    ts = []
    for _ in range(reps):
        t0 = time.perf_counter()
        _, _, _, res = jax.block_until_ready(compiled(xs0, ys0))
        ts.append(time.perf_counter() - t0)
    res_host = np.asarray(res)
    return (
        batch / float(np.median(ts)),
        float(np.median(res_host)),
        float(np.max(res_host)),
    )


def measure(problem, option, device_counts, per_device, max_steps, reps=3):
    """Weak-scaling sweep rates at each device count.

    Returns a list of {devices, batch, solves_per_sec, efficiency, ...}
    dicts; efficiency is relative to the smallest device count measured.
    """
    import jax

    from riptrm_tpu.parallel.sweep import make_mesh

    devices = jax.devices()
    rows = []
    base_rate = None
    base_d = None
    for d in device_counts:
        if d > len(devices):
            break
        mesh = make_mesh({"dp": d}, devices[:d])
        rate, med, mx = sweep_rate(
            problem, option, mesh, per_device * d, max_steps, reps
        )
        if base_rate is None:
            base_rate, base_d = rate, d
        rows.append(
            {
                "devices": d,
                "batch": per_device * d,
                "solves_per_sec": round(rate, 3),
                "efficiency": round(rate / (base_rate * d / base_d), 4),
                "median_residual": med,
                "max_residual": mx,
            }
        )
    return rows


def main(argv=None):
    argv = list(sys.argv[1:] if argv is None else argv)
    from riptrm_tpu.experiment.cfg import maybe_help

    maybe_help(argv, __doc__)
    n = 256
    per_device = 4
    max_steps = 200
    cpu = False
    virtual = 0
    out = None
    it = iter(argv)
    for a in it:
        if a == "--n":
            n = int(next(it))
        elif a == "--per-device":
            per_device = int(next(it))
        elif a == "--max-steps":
            max_steps = int(next(it))
        elif a == "--cpu":
            cpu = True
        elif a == "--virtual-devices":
            virtual = int(next(it))
        elif a == "--out":
            out = next(it)
        else:
            raise SystemExit(f"unknown arg {a}")

    if virtual:
        import os

        flags = os.environ.get("XLA_FLAGS", "")
        os.environ["XLA_FLAGS"] = (
            f"{flags} --xla_force_host_platform_device_count={virtual}"
        )
        cpu = True

    from riptrm_tpu.config import setup

    setup(cpu=cpu, x64=False)
    import jax
    import jax.numpy as jnp

    from riptrm_tpu.problems import nonneg_pca

    k1, k2 = jax.random.split(jax.random.PRNGKey(0))
    data = nonneg_pca.generate_instance(k1, n)
    x0 = np.abs(np.asarray(jax.random.normal(k2, (n,))))
    x0 /= np.linalg.norm(x0)
    problem = nonneg_pca.make_problem(data["Z"], x0, dtype=jnp.float32)
    # f32 forcing floors (the reference's 1e-14 floors assume f64)
    option = {
        "maxiter": 60,
        "tolresid": 3e-4,
        "TRS_solver": "tCG",
        "second_order_stationarity": False,
        "forcing_function_Lagrangian": lambda mu: jnp.maximum(mu, 1e-4),
        "forcing_function_complementarity": lambda mu: jnp.maximum(1e-3 * mu, 2e-4),
    }

    n_dev = len(jax.devices())
    counts = []
    d = 1
    while d <= n_dev:
        counts.append(d)
        d *= 2
    rows = measure(problem, option, counts, per_device, max_steps)
    for r in rows:
        print(json.dumps(r))
    if out:
        with open(out, "w") as f:
            json.dump(rows, f, indent=1)


if __name__ == "__main__":
    main()
