"""StableIdentification d=32 deep-residual CPU/x64 run.

Round 4 left the flagship-scale question open: the best residual ever
recorded at d=32 was 0.123 (one f32 RIPM-Krylov chip lane; median 0.436),
and "deep d=32 is a CPU/x64 job" was asserted, never measured.  This
driver runs the d=32 instances (same build_sweep payload/seed as the chip
sweeps, via the dataset/_cache npz) on the host CPU in float64, segmented
(progress JSONL per segment, atomic npz checkpoint), for three arms:

* RIPTRM  — tCG mode, x64 forcing floors (the f32 chip run oscillated);
* RIPM    — matrix-free Krylov condensed Newton (the only solver that
            made progress at d=32 on chip);
* RIPM-P  — same + KrylovPreconditioner='jacobi_theta' (round-5 lever).

x64 separates the two hypotheses: residuals diving far below 0.123 mean
the chip floor was f32 conditioning; an x64 flatline at the same level
means the landscape itself (annulus-sliver margins, barrier cond ~1e12)
is the floor.

    python scripts/sid32_cpu_deep.py --arm ripm [--batch 8]
"""

from __future__ import annotations

import argparse
import json
import os
import sys
import time

import numpy as np

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))


def main():
    parser = argparse.ArgumentParser()
    parser.add_argument("--arm", choices=["riptrm", "ripm", "ripm_p"],
                        required=True)
    parser.add_argument("--batch", type=int, default=8)
    parser.add_argument("--size", type=int, default=32)
    parser.add_argument("--seed", type=int, default=0)
    parser.add_argument("--segments", type=int, default=40)
    parser.add_argument("--segment-steps", type=int, default=50)
    parser.add_argument("--krylov-iters", type=int, default=400)
    parser.add_argument("--tolresid", type=float, default=1e-9)
    args = parser.parse_args()

    from riptrm_tpu.config import setup

    jax = setup(cpu=True, x64=True)
    import jax.numpy as jnp

    from riptrm_tpu.experiment.chip_sweep import build_sweep
    from riptrm_tpu.ops.kkt import compute_residual

    t0 = time.time()
    problem32, xs0_f32, ys0_f32 = build_sweep(
        "StableIdentification", args.size, args.batch, args.seed
    )
    # rebuild the SAME instance at f64 from the cached payload
    from riptrm_tpu.experiment.chip_sweep import _cache_load
    from riptrm_tpu.problems import stable_identification as si

    payload = _cache_load("StableIdentification", args.size, args.batch,
                          args.seed)
    starts = (payload["b_J"], payload["b_R"], payload["b_Q"])
    problem = si.make_problem(
        args.size, list(payload["trajs"]), payload["constset"],
        tuple(a[0] for a in starts), dtype=jnp.float64,
    )
    xs0 = tuple(jnp.asarray(a, jnp.float64) for a in starts)
    ys0 = jnp.ones((args.batch, problem.num_ineq), jnp.float64)
    gen_s = time.time() - t0

    if args.arm == "riptrm":
        from riptrm_tpu.solvers.riptrm import RIPTRM
        from riptrm_tpu.solvers import riptrm as riptrm_mod

        option = RIPTRM({
            "maxiter": 10_000,
            "tolresid": args.tolresid,
            "TRS_solver": "tCG",
            "second_order_stationarity": False,
        }).option
        step_fn = riptrm_mod.make_step(problem, option)

        def start(x0, y0):
            from riptrm_tpu.parallel.sweep import init_state_from

            return init_state_from(problem, option, x0, y0)

        def get_xye(st):
            return st.x, st.y, jnp.zeros((0,), jnp.float64)

    else:
        from riptrm_tpu.solvers import ripm

        option = ripm.RIPM({
            "maxiter": 100_000,
            "tolresid": args.tolresid,
            "KrylovIterMethod": True,
            "KrylovMaxIteration": args.krylov_iters,
            "KrylovPreconditioner": (
                "jacobi_theta" if args.arm == "ripm_p" else "none"
            ),
        }).option
        raw_step = ripm.make_step(problem, option)

        def start(x0, y0):
            m = problem.num_ineq
            f = ripm._kkt_field(problem, x0, jnp.zeros((0,), jnp.float64),
                                y0, y0)
            phi0 = ripm._phi(problem, x0, *f)
            st0 = ripm.RipmState(
                x=x0, y=jnp.zeros((0,), jnp.float64), z=y0, s=y0, phi=phi0,
                sigma=jnp.minimum(0.5, phi0**0.25),
                rho=jnp.vdot(y0, y0) / m,
                gamma=jnp.asarray(option["gamma"], jnp.float64),
                iteration=jnp.asarray(0),
            )
            tau_1 = jnp.min(y0 * y0) * m / jnp.vdot(y0, y0)
            tau_2 = jnp.vdot(y0, y0) / jnp.sqrt(phi0)
            return st0, tau_1, tau_2

        def get_xye(st):
            return st.x, st.z, st.y

    if args.arm == "riptrm":
        sts = jax.vmap(start)(xs0, ys0)
        extras = ()

        def seg_body(st, _):
            new_st, info = step_fn(st)
            return new_st, None

        def segment(sts):
            def one(st):
                st, _ = jax.lax.scan(seg_body, st, None,
                                     length=args.segment_steps)
                return st

            return jax.vmap(one)(sts)
    else:
        sts, t1s, t2s = jax.vmap(start)(xs0, ys0)
        extras = (t1s, t2s)

        def segment(sts):
            def one(st, t1, t2):
                def body(st, _):
                    new_st, info = raw_step(st, t1, t2)
                    return new_st, None

                st, _ = jax.lax.scan(body, st, None,
                                     length=args.segment_steps)
                return st

            return jax.vmap(one)(sts, t1s, t2s)

    seg_c = jax.jit(segment)
    res_fn = jax.jit(jax.vmap(
        lambda st: compute_residual(problem, *get_xye(st))[0]
    ))

    best = np.asarray(res_fn(sts))
    t1 = time.time()
    for i in range(args.segments):
        sts = seg_c(sts)
        res = np.asarray(res_fn(sts))
        best = np.minimum(best, np.where(np.isnan(res), np.inf, res))
        row = {
            "arm": args.arm,
            "segment": i,
            "steps": (i + 1) * args.segment_steps,
            "median_residual": float(np.median(res)),
            "min_residual": float(np.min(res)),
            "best_median": float(np.median(best)),
            "best_min": float(np.min(best)),
            "t": round(time.time() - t1, 1),
        }
        print(json.dumps(row), flush=True)
        np.savez(
            f"/tmp/sid32_cpu_deep_{args.arm}.npz",
            **{f"leaf{j}": np.asarray(l)
               for j, l in enumerate(jax.tree.leaves(sts))},
            best=best,
        )
        if float(np.median(best)) <= args.tolresid:
            break
    print(json.dumps({
        "arm": args.arm,
        "final": True,
        "batch": args.batch,
        "steps": (i + 1) * args.segment_steps,
        "best_median": float(np.median(best)),
        "best_min": float(np.min(best)),
        "best_per_lane": [float(b) for b in best],
        "run_s": round(time.time() - t1, 1),
        "gen_s": round(gen_s, 1),
        "x64": True,
    }), flush=True)


if __name__ == "__main__":
    main()
