"""Simulation pipeline: coordinator -> solver(s) -> CSV persistence.

Parity targets: ``/root/reference/src/base/base_simulator.py`` and the
per-problem ``simulator.py`` overrides (output files keyed by the solver's
decorated ``output.name`` — e.g. ``RIPTRM_tCG_log.csv`` — which the
analyzers depend on; ``NonnegPCA/simulator.py:40``).

CLI:
    python -m riptrm_tpu.experiment.simulate --config configs/NonnegPCA/config_simulation.yaml
    python -m riptrm_tpu.experiment.simulate --problem NonnegPCA [-m] [--cpu] [key=value ...]

Runs on the default device (the GPU where one is present) with float64
enabled; ``--cpu`` pins the CPU backend for host parity runs.
"""

from __future__ import annotations

import csv
import logging
import os
import sys

import numpy as np

from riptrm_tpu.experiment.cfg import (
    Config,
    load_config,
    solver_options_from_cfg,
    sweep_configs,
)
from riptrm_tpu.experiment.registry import SOLVERS, build_problem

logger = logging.getLogger(__name__)


def save_output(output_path: str, name: str, output) -> None:
    """Persist every Output attribute (``base_simulator.py:75-95``):
    ``<output_path>/<name>_{x,ineqLagmult,eqLagmult,option,log}.csv``."""
    os.makedirs(output_path, exist_ok=True)
    for attr, content in vars(output).items():
        if attr == "name":
            continue
        path = f"{output_path}/{name}_{attr}.csv"
        if isinstance(content, dict):
            content = {
                k: (v if isinstance(v, list) else [v]) for k, v in content.items()
            }
            content = {
                k: ["" if vv is None else vv for vv in v] for k, v in content.items()
            }
            lengths = {len(v) for v in content.values()}
            if len(lengths) > 1:
                raise ValueError(f"{path}: columns of unequal length {lengths}")
            with open(path, "w", newline="") as f:
                writer = csv.writer(f, lineterminator="\n")
                writer.writerow(content.keys())
                writer.writerows(zip(*content.values()))
        elif isinstance(content, (tuple, list)):
            # product-manifold point: block format, one block per component
            with open(path, "w") as f:
                for block in content:
                    arr = np.atleast_2d(np.asarray(block))
                    f.write(f"# block {arr.shape[0]} {arr.shape[1]}\n")
                    np.savetxt(f, arr)
        else:
            arr = np.asarray(content)
            np.savetxt(path, np.atleast_1d(arr))


def load_block_file(path: str):
    """Read the block format written by :func:`save_output` (the analog of
    ``analyzer_strict_complementarity.load_block_file``,
    ``/root/reference/src/StableIdentification/analyzer_strict_complementarity.py:6-34``)."""
    blocks = []
    rows: list = []
    shape = None
    with open(path) as f:
        for line in f:
            line = line.strip()
            if line.startswith("# block"):
                if shape is not None:
                    blocks.append(np.asarray(rows).reshape(shape))
                parts = line.split()
                shape = (int(parts[2]), int(parts[3]))
                rows = []
            elif line:
                rows.append([float(v) for v in line.split()])
    if shape is not None:
        blocks.append(np.asarray(rows).reshape(shape))
    return blocks


class Simulator:
    """``base_simulator.Simulator`` equivalent."""

    def __init__(self, cfg: Config):
        for attr in (
            "problem_name",
            "problem_instance",
            "problem_initialpoint",
            "solver_name",
            "solver_option",
        ):
            assert attr in cfg, f"config missing {attr}"
        self.cfg = cfg

    def run(self):
        cfg = self.cfg
        out_dir = cfg.get_path("output_path") or (
            f"intermediate/{cfg.problem_name}/{cfg.problem_instance}/"
            f"{cfg.problem_initialpoint}"
        )
        os.makedirs(out_dir, exist_ok=True)
        logger.info(
            "Running simulator -- instance: %s, initial point: %s",
            cfg.problem_instance,
            cfg.problem_initialpoint,
        )
        problem = build_problem(cfg)
        names = cfg.solver_name
        if isinstance(names, str):
            names = [names]
        skip_existing = bool(cfg.get_path("skip_existing", False))
        for name in names:
            option = solver_options_from_cfg(cfg, name)
            solver = SOLVERS[name](option)
            if skip_existing:
                from riptrm_tpu.experiment.checkpoint import job_is_done

                if job_is_done(out_dir, solver.name):
                    logger.info("Skipping completed job %s", solver.name)
                    continue
            logger.info("Running solver %s", solver.name)
            output = solver.run(problem)
            save_output(out_dir, output.name, output)
            logger.info("Finished solver %s", solver.name)


def main(argv=None):
    argv = list(sys.argv[1:] if argv is None else argv)
    from riptrm_tpu.experiment.cfg import maybe_help

    maybe_help(argv, __doc__)
    logging.basicConfig(level=logging.INFO, format="[%(asctime)s][%(name)s] %(message)s")
    multirun = False
    config_path = None
    cpu = False
    overrides = []
    it = iter(argv)
    for a in it:
        if a in ("-m", "--multirun"):
            multirun = True
        elif a == "--cpu":
            cpu = True
        elif a == "--config":
            config_path = next(it)
        elif a == "--problem":
            config_path = f"configs/{next(it)}/config_simulation.yaml"
        else:
            overrides.append(a)
    if config_path is None:
        raise SystemExit(
            "usage: simulate (--config PATH | --problem NAME) [-m] [--cpu] [key=value ...]"
        )
    # x64 always: the reference protocol's tolerances are f64-deep.
    from riptrm_tpu.config import setup

    setup(cpu=cpu)
    if multirun:
        for cfg in sweep_configs(config_path, overrides):
            Simulator(cfg).run()
    else:
        Simulator(load_config(config_path, overrides)).run()


if __name__ == "__main__":
    main()
