"""Time-to-reference-target speedrun of the full paper protocol.

The reference evaluates each (problem, instance, initial point, solver) job
as the minimum KKT residual reached within a 240 s budget (SURVEY §6;
BASELINE.md).  This CLI measures how fast the batched compiled solvers
reach those SAME residuals: every job's target is the best residual the
full-budget host-protocol run achieved (``result/benchmark_summary.json``,
the reference-parity numbers), each solver's jobs for a problem run as ONE
vmapped compiled solve whose lanes stop individually at their targets
(``parallel.sweep.batched_protocol_sweep``), and the report compares total
wall-clock against the reference's ``240 s x jobs`` budget — the
BASELINE.json north-star claim ("solve the paper's full benchmark sweep to
reference optimality in <=10% of CPU wall-clock").

    python -m riptrm_tpu.experiment.protocol_speedrun
        [--problems NonnegPCA,...] [--summary result/benchmark_summary.json]
        [--out result/protocol_speedrun.json] [--slack 1.0] [--cpu]

Notes: runs in float64 on the default device (the GPU where one is
present; reference tolerances are f64-deep), or on the CPU backend with
``--cpu``.  RIPM's ``checkNTequation`` debug self-check is disabled here (it is
diagnostic logging, not part of the solve).  Compile time is reported
separately — the reference's per-job budget excludes its import/setup too,
and the compile is paid once per (problem, solver), not per job.
"""

from __future__ import annotations

import json
import sys
import time

import numpy as np

PROBLEMS = ["NonnegPCA", "Rosenbrock", "StableIdentification"]
REFERENCE_BUDGET_S = 240.0


def stack_points(cfgs):
    """Per-point problems -> (problem, stacked x0s, stacked y0s, points)."""
    import jax
    import jax.numpy as jnp

    from riptrm_tpu.experiment.registry import build_problem

    problems = [build_problem(c) for c in cfgs]
    xs0 = jax.tree.map(lambda *ls: jnp.stack(ls), *[p.x0 for p in problems])
    ys0 = jnp.stack([jnp.asarray(p.y0) for p in problems])
    return problems[0], xs0, ys0, [str(c.problem_initialpoint) for c in cfgs]


def rescue_missed_lanes(
    problem, solver_name, option, max_steps, xs0, ys0, targets, best_h, ks_h
):
    """Unbatched rescue pass for lanes the vmapped sweep misses.

    Lanes with ``best > target`` are re-run as UNBATCHED compiled solves
    (``parallel.sweep.protocol_single``): vmapped lanes see different f64
    reduction orderings, and at chaotic accept/reject plateaus that
    legitimately tips a trajectory away from the host's (CLAUDE.md
    invariants) — the scalar program reproduces the host protocol.  Mutates
    ``best_h``/``ks_h`` in place (keeps each lane's better result) and
    returns (rescued_flags, run_s, compile_s): rescue wall-clock counts
    toward the speedrun's run time, its AOT compile is reported apart.
    """
    import jax
    import numpy as np

    from riptrm_tpu.parallel.sweep import protocol_single

    rescued = [False] * len(targets)
    missed = [
        i
        for i, (b, t) in enumerate(zip(best_h, targets))
        if not (b <= t) and np.isfinite(t) and t > 0.0
    ]
    if not missed:
        return rescued, 0.0, 0.0
    single = protocol_single(problem, solver_name, option, max_steps)
    lane = lambda tree, i: jax.tree.map(lambda a: a[i], tree)
    t0 = time.perf_counter()
    lowered = single.lower(
        lane(xs0, 0), ys0[0], jnp_scalar(targets[0], ys0.dtype)
    ).compile()
    compile_s = time.perf_counter() - t0
    t0 = time.perf_counter()
    for i in missed:
        _, _, k1, b1 = jax.block_until_ready(lowered(
            lane(xs0, i), ys0[i], jnp_scalar(targets[i], ys0.dtype)
        ))
        b1 = float(np.asarray(b1))
        if b1 < best_h[i]:
            best_h[i] = b1
            ks_h[i] = int(np.asarray(k1))
        rescued[i] = True
    run_s = time.perf_counter() - t0
    return rescued, run_s, compile_s


def jnp_scalar(v, dtype):
    import jax.numpy as jnp

    return jnp.asarray(v, dtype=dtype)


def _next_arg(it, flag):
    try:
        return next(it)
    except StopIteration:
        raise SystemExit(f"{flag} requires a value") from None


def run_protocol(problems=PROBLEMS, summary_path="result/benchmark_summary.json",
                 slack=1.0, max_steps=50_000, solver_filter=None,
                 option_overrides=None, out_path=None):
    """Run the time-to-target protocol on the default device.

    For every (problem, instance, solver) group, all initial points run as
    one batched compiled solve toward their reference targets, then missed
    lanes get the unbatched rescue pass.  Returns the report dict
    (``groups`` and ``total``); with ``out_path`` the report is also
    rewritten after every group, so a killed run keeps its partials.
    Expects x64 to be enabled (``config.setup``).
    """
    import jax
    import jax.numpy as jnp

    from riptrm_tpu.experiment.cfg import solver_options_from_cfg, sweep_configs
    from riptrm_tpu.experiment.registry import SOLVERS
    from riptrm_tpu.parallel.sweep import batched_protocol_sweep

    with open(summary_path) as f:
        targets_by_key = json.load(f)

    report = {"groups": {}}
    total_run_s = 0.0
    total_compile_s = 0.0
    n_jobs = 0
    for problem_name in problems:
        all_cfgs = sweep_configs(f"configs/{problem_name}/config_simulation.yaml")
        # Group by instance: each instance is its own problem data and its
        # own target keys (lanes batch over initial points only).
        by_instance: dict = {}
        for c in all_cfgs:
            by_instance.setdefault(str(c.problem_instance), []).append(c)
        for instance, cfgs in by_instance.items():
            problem, xs0, ys0, points = stack_points(cfgs)
            cfg0 = cfgs[0]
            for solver_name in cfg0.solver_name:
                if solver_filter and solver_name not in solver_filter:
                    continue
                option = solver_options_from_cfg(cfg0, solver_name)
                option.pop("maxtime", None)  # compiled: no wall clock
                option["checkNTequation"] = False
                if solver_name == "RSQO":
                    # Deep-parity QP settings (measured A/B on StableId
                    # instance 1, 1e-15-class targets): the condensed-
                    # Cholesky warm-started QP — the right default for f32
                    # sweeps — perturbs each QP solution within its
                    # tolerance, and over 10^4 SQP steps that plateaus
                    # lanes at 1e-2..1e-13 where LU + cold start drives
                    # them to the 3.3e-15 reference floor.
                    option["quadoptim_linear_solver"] = "lu"
                    option["quadoptim_warm_start"] = False
                option.update(option_overrides or {})
                decorated = SOLVERS[solver_name](option).name
                targets, missing = [], []
                for pt in points:
                    key = f"{problem_name}/{instance}/{pt}/{decorated}"
                    t = targets_by_key.get(key)
                    if t is None or not np.isfinite(t):
                        missing.append(key)
                        t = 0.0  # run the full schedule; reported as miss
                    targets.append(float(t) * slack)
                if missing:
                    print(
                        f"WARNING: no finite target for {len(missing)} "
                        f"job(s) (e.g. {missing[0]}); those lanes run the "
                        "full maxiter schedule",
                        flush=True,
                    )
                targets_a = jnp.asarray(targets, dtype=jnp.float64)

                fn = batched_protocol_sweep(
                    problem, solver_name, option, max_steps
                )
                # AOT-compile before the clock (compile time excluded,
                # measured separately).
                t0 = time.perf_counter()
                compiled = jax.jit(fn).lower(xs0, ys0, targets_a).compile()
                compile_s = time.perf_counter() - t0
                t0 = time.perf_counter()
                x, y, ks, best = jax.block_until_ready(
                    compiled(xs0, ys0, targets_a)
                )
                run_s = time.perf_counter() - t0
                best_h = np.array(best)  # writable copies (rescue updates)
                ks_h = np.array(ks)

                # ---- unbatched rescue pass (see rescue_missed_lanes) -----
                rescued, rescue_run_s, rescue_compile_s = rescue_missed_lanes(
                    problem, solver_name, option, max_steps,
                    xs0, ys0, targets, best_h, ks_h,
                )
                run_s += rescue_run_s
                compile_s += rescue_compile_s

                group = {
                    "points": points,
                    "targets": targets,
                    "best": [float(b) for b in best_h],
                    "steps": [int(k) for k in ks_h],
                    "reached": [
                        bool(b <= t) for b, t in zip(best_h, targets)
                    ],
                    "rescued": rescued,
                    "missing_targets": missing,
                    "run_s": run_s,
                    "compile_s": compile_s,
                }
                if solver_name == "RIPTRM" and problem_name in (
                    "NonnegPCA", "Rosenbrock"
                ):
                    # Post-hoc second-order certificates at every final
                    # point (one batched matrix-free Lanczos); the
                    # protocol's tCG config leaves the in-loop check off
                    # (reference config parity).  Only AFFINE-constraint
                    # problems: there Hess g = 0, so the Lagrangian term
                    # is y-independent and the ratio-capped certificate is
                    # meaningful; with nonlinear constraints
                    # (StableIdentification's annulus) terminal duals
                    # clipped at 1e20 make any terminal-point curvature
                    # bound vacuous.
                    from riptrm_tpu.parallel.sweep import certify_second_order

                    mineigs = certify_second_order(problem, x, y, ratio_cap=1e8)
                    group["second_order_mineig"] = [
                        float(v) for v in np.asarray(mineigs)
                    ]
                report["groups"][f"{problem_name}/{instance}/{decorated}"] = group
                total_run_s += run_s
                total_compile_s += compile_s
                n_jobs += len(points)
                if out_path:
                    with open(out_path, "w") as f:
                        json.dump(report, f, indent=1)
                print(
                    f"{problem_name}/{instance}/{decorated}: {len(points)} "
                    f"jobs in {run_s:.3f}s (compile {compile_s:.1f}s), "
                    f"{sum(group['reached'])}/{len(points)} targets reached",
                    flush=True,
                )

    ref_total = REFERENCE_BUDGET_S * n_jobs
    dev = jax.devices()[0]
    report["total"] = {
        "jobs": n_jobs,
        "run_s": total_run_s,
        "compile_s": total_compile_s,
        "reference_budget_s": ref_total,
        "run_fraction_of_reference": total_run_s / ref_total if n_jobs else None,
        "run_plus_compile_fraction": (
            (total_run_s + total_compile_s) / ref_total if n_jobs else None
        ),
        "device": {"platform": dev.platform, "kind": dev.device_kind},
    }
    if out_path:
        with open(out_path, "w") as f:
            json.dump(report, f, indent=1)
    return report


def main(argv=None):
    argv = list(sys.argv[1:] if argv is None else argv)
    from riptrm_tpu.experiment.cfg import maybe_help

    maybe_help(argv, __doc__)
    problems = PROBLEMS
    summary_path = "result/benchmark_summary.json"
    out_path = "result/protocol_speedrun.json"
    slack = 1.0
    max_steps = 50_000
    cpu = False
    solver_filter = None
    option_overrides = {}
    it = iter(argv)
    for a in it:
        if a == "--problems":
            problems = _next_arg(it, a).split(",")
        elif a == "--summary":
            summary_path = _next_arg(it, a)
        elif a == "--out":
            out_path = _next_arg(it, a)
        elif a == "--slack":
            slack = float(_next_arg(it, a))
        elif a == "--max-steps":
            max_steps = int(_next_arg(it, a))
        elif a == "--cpu":
            cpu = True
        elif a == "--solvers":
            solver_filter = set(_next_arg(it, a).split(","))
        elif a == "--option":
            # key=value applied to every solver option dict (A/B studies,
            # e.g. --solvers RALM --option tolgradnorm_decay_fix=true)
            k, _, v = _next_arg(it, a).partition("=")
            lv = v.lower()
            if lv in ("true", "false"):
                option_overrides[k] = lv == "true"
            else:
                try:
                    option_overrides[k] = int(v)
                except ValueError:
                    try:
                        option_overrides[k] = float(v)
                    except ValueError:
                        option_overrides[k] = v  # string option (e.g.
                        # quadoptim_linear_solver=schulz)
        else:
            raise SystemExit(f"unknown arg {a}")

    # x64 always: the reference residual targets are f64-deep (f32 lanes
    # could never reach them and would burn the full schedule).
    from riptrm_tpu.config import setup

    setup(cpu=cpu)
    report = run_protocol(
        problems, summary_path, slack, max_steps, solver_filter,
        option_overrides, out_path,
    )
    print(json.dumps(report["total"]), flush=True)


if __name__ == "__main__":
    main()
