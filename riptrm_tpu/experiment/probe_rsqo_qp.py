"""Per-SQP-step QP iteration/status probe for the batched RSQO sweep.

The chip-sweep CLI reports aggregate solves/s and residuals; this probe
answers the companion question for the QP linear-solver A/B: how many Mehrotra IPM iterations does each SQP step pay under
each ``quadoptim_linear_solver`` flavor, and do any lanes freeze
(status 2)?  It vmaps the raw RSQO step (``solvers/rsqo.py::make_step``,
which surfaces ``quadoptim_iter``/``quadoptim_status`` in its info dict —
the compiled sweep loop drops them) over the same instance/starts as
``chip_sweep`` and scans a fixed number of SQP steps.

    python -m riptrm_tpu.experiment.probe_rsqo_qp --problem NonnegPCA \
        --size 200 --batch 16 --steps 12 --linear-solver schulz

Reference: the QP being profiled replaces CVXOPT at
``/root/reference/src/solver/RSQO.py:196-208``.
"""

from __future__ import annotations

import argparse
import json
import time

import numpy as np


def main(argv=None):
    parser = argparse.ArgumentParser(description=__doc__)
    parser.add_argument("--problem", default="NonnegPCA")
    parser.add_argument("--size", type=int, default=200)
    parser.add_argument("--batch", type=int, default=16)
    parser.add_argument("--steps", type=int, default=12)
    parser.add_argument("--linear-solver", default="chol",
                        choices=["chol", "lu", "schulz"])
    parser.add_argument("--qp-mode", default="reghess_shift",
                        choices=["reghess", "reghess_shift",
                                 "reghess_operator", "eye"])
    parser.add_argument("--precision", default="high",
                        choices=["high", "highest"])
    parser.add_argument("--seed", type=int, default=0)
    args = parser.parse_args(argv)

    from riptrm_tpu.config import setup

    jax = setup(x64=False)
    jax.config.update("jax_default_matmul_precision", args.precision)

    from riptrm_tpu.experiment.chip_sweep import build_sweep
    from riptrm_tpu.solvers import rsqo

    t0 = time.perf_counter()
    problem, xs0, ys0 = build_sweep(args.problem, args.size, args.batch,
                                    args.seed, matmul_precision=args.precision)
    gen_s = time.perf_counter() - t0

    opt = rsqo.RSQO({
        "maxiter": 60,
        "tolresid": 3e-4,
        "quadoptim_type": args.qp_mode,
        "quadoptim_linear_solver": args.linear_solver,
    }).option
    base = rsqo.init_state(problem, opt)
    st0 = jax.vmap(lambda x, y: base._replace(x=x, y=y))(xs0, ys0)
    step = rsqo.make_step(problem, opt)

    @jax.jit
    def run(st0):
        def body(st, _):
            st, info = jax.vmap(step)(st)
            return st, (info["quadoptim_iter"], info["quadoptim_status"])

        _, (iters, status) = jax.lax.scan(body, st0, None, length=args.steps)
        return iters, status  # [steps, B]

    compiled = run.lower(st0).compile()
    t0 = time.perf_counter()
    iters, status = jax.tree.map(
        np.asarray, jax.block_until_ready(compiled(st0))
    )
    run_s = time.perf_counter() - t0
    out = {
        "problem": args.problem,
        "size": args.size,
        "batch": args.batch,
        "steps": args.steps,
        "linear_solver": args.linear_solver,
        "qp_iter_mean": round(float(iters.mean()), 2),
        "qp_iter_max": int(iters.max()),
        "qp_iter_by_step_mean": [round(float(r), 1) for r in iters.mean(axis=1)],
        "frozen_lane_steps": int((status == 2).sum()),
        "maxed_lane_steps": int((status == 1).sum()),
        "gen_s": gen_s,
        "run_s": run_s,
        "device": jax.devices()[0].device_kind,
    }
    print(json.dumps(out))


if __name__ == "__main__":
    main()
