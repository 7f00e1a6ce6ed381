"""Full paper-protocol benchmark sweep (BASELINE.md / BASELINE.json cfg 5).

Runs 3 problems x instances x initial points x the solver grid under the
reference protocol (240 s budget, maxiter 10000, min-KKT-residual metric),
sharded across host processes, restartable via ``skip_existing``, and
summarizes best-residual-within-budget per job.

    python -m riptrm_tpu.experiment.benchmark [--budget 240] [--problems A,B]
        [--solvers RIPTRM,...] [--scale 1.0] [--cpu]

Runs on the default device (the GPU where one is present) with float64
enabled; ``--cpu`` pins the CPU backend for host parity runs.

``--scale`` shrinks the wall-clock budget for smoke runs (e.g. 0.05 ->
12 s per solve).
"""

from __future__ import annotations

import json
import os
import sys

import numpy as np

from riptrm_tpu.experiment.analyzer import best_residual_within, filter_riptrm_rows, load_log
from riptrm_tpu.experiment.cfg import sweep_configs
from riptrm_tpu.experiment.simulator import Simulator
from riptrm_tpu.parallel.distributed import host_shard

PROBLEMS = ["NonnegPCA", "Rosenbrock", "StableIdentification"]


def jobs_for(problem: str, overrides):
    path = f"configs/{problem}/config_simulation.yaml"
    return sweep_configs(path, overrides)


def _next_arg(it, flag):
    try:
        return next(it)
    except StopIteration:
        raise SystemExit(f"{flag} requires a value") from None


def main(argv=None):
    argv = list(sys.argv[1:] if argv is None else argv)
    from riptrm_tpu.experiment.cfg import maybe_help

    maybe_help(argv, __doc__)
    budget = 240.0
    problems = PROBLEMS
    solvers = None
    scale = 1.0
    summary_path = "result/benchmark_summary.json"
    cpu = False
    extra = []
    it = iter(argv)
    for a in it:
        if a == "--cpu":
            cpu = True
        elif a == "--budget":
            budget = float(_next_arg(it, a))
        elif a == "--problems":
            problems = _next_arg(it, a).split(",")
        elif a == "--solvers":
            solvers = _next_arg(it, a).split(",")
        elif a == "--scale":
            scale = float(_next_arg(it, a))
        elif a == "--summary":
            summary_path = _next_arg(it, a)
        else:
            extra.append(a)

    # x64 always: reference tolerances (1e-16) need f64.
    from riptrm_tpu.config import setup

    setup(cpu=cpu)

    budget_eff = budget * scale
    summary = {}
    for problem in problems:
        overrides = list(extra) + [
            f"solver_option.common.maxtime={budget_eff}",
            "skip_existing=true",
        ]
        if solvers:
            overrides.append(f"solver_name=[{','.join(solvers)}]")
        cfgs = jobs_for(problem, overrides)
        cfgs = host_shard(cfgs)
        for cfg in cfgs:
            Simulator(cfg).run()
            out_dir = cfg.get_path("output_path")
            for f in os.listdir(out_dir):
                if not f.endswith("_log.csv"):
                    continue
                name = f[: -len("_log.csv")]
                df = load_log(out_dir, name)
                if name.startswith("RIPTRM"):
                    df = filter_riptrm_rows(df)
                key = f"{problem}/{cfg.problem_instance}/{cfg.problem_initialpoint}/{name}"
                summary[key] = best_residual_within(df, budget_eff)

    os.makedirs(os.path.dirname(summary_path) or ".", exist_ok=True)
    with open(summary_path, "w") as f:
        json.dump(summary, f, indent=1, sort_keys=True)
    for k in sorted(summary):
        v = summary[k]
        print(f"{k}: best residual {v:.3e}" if np.isfinite(v) else f"{k}: n/a")


if __name__ == "__main__":
    main()
