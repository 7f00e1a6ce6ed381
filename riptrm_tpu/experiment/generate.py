"""Dataset generation pipeline.

Parity targets: ``/root/reference/src/base/dataset_generator.py`` plus the
per-problem generators (``NonnegPCA/generator.py``,
``Rosenbrock/generator.py``, ``StableIdentification/generator.py``).
Randomness uses explicit seeds (config key ``seed``; per-instance offset)
instead of the reference's global numpy RNG.

CLI:
    python -m riptrm_tpu.experiment.generate --problem NonnegPCA [-m] [key=value ...]
"""

from __future__ import annotations

import logging
import os
import sys

import jax
import numpy as np

from riptrm_tpu.experiment.cfg import load_config, sweep_configs
from riptrm_tpu.problems import nonneg_pca
from riptrm_tpu.problems import stable_identification as si

logger = logging.getLogger(__name__)


def _save(outdir: str, name: str, arr) -> None:
    os.makedirs(outdir, exist_ok=True)
    np.savetxt(f"{outdir}/{name}.csv", np.asarray(arr, dtype=float))


def _instance_seed(cfg) -> int:
    base = int(cfg.get_path("seed", 0) or 0)
    return base * 1000003 + int(cfg.instance_name)


def generate_nonneg_pca(cfg):
    """``NonnegPCA/generator.py``: spiked Z + initial points + dual init."""
    outdir = cfg.get_path("output_path") or f"dataset/{cfg.problem_name}/{cfg.instance_name}"
    key = jax.random.PRNGKey(_instance_seed(cfg))
    kz, kp = jax.random.split(key)
    dim = int(cfg.dim)
    data = nonneg_pca.generate_instance(kz, dim, float(cfg.snr), float(cfg.delta))
    _save(outdir, "dim", [[dim]])
    _save(outdir, "Z", data["Z"])
    feasible = cfg.get_path("initialpoints_type", "feasible") == "feasible"
    for i, name in enumerate(cfg.initialpoints):
        x0 = nonneg_pca.generate_initialpoint(jax.random.fold_in(kp, i), dim, feasible)
        _save(outdir, f"initx_{name}", x0)
    _save(outdir, "initineqLagmult", np.ones(dim))


def generate_rosenbrock(cfg):
    """``Rosenbrock/generator.py``: identity initial point + dual init."""
    outdir = cfg.get_path("output_path") or f"dataset/{cfg.problem_name}/{cfg.instance_name}"
    dim = int(cfg.dim)
    _save(outdir, "dim", [[dim]])
    _save(outdir, "initx", np.eye(dim))
    _save(outdir, "initineqLagmult", np.ones(dim * dim))


def generate_stable_identification(cfg):
    """``StableIdentification/generator.py``: true system, constraints,
    trajectories with AWGN, RALM-based interior initial points."""
    outdir = cfg.get_path("output_path") or f"dataset/{cfg.problem_name}/{cfg.instance_name}"
    seed = _instance_seed(cfg)
    rng = np.random.default_rng(seed)
    key = jax.random.PRNGKey(seed)
    d = int(cfg.dim)
    scaling = float(cfg.get_path("scaling", 1.0))

    while True:
        try:
            k1, k2, key = jax.random.split(key, 3)
            J, R, Q, A = si.generate_true_system(k1, d, scaling)
            constset = si.generate_constraints(
                rng, d, A, float(cfg.oneboxratio), float(cfg.twoboxratio)
            )
            _save(outdir, "dim", [[d]])
            _save(outdir, "constset", constset)
            _save(outdir, "true_J", J)
            _save(outdir, "true_R", R)
            _save(outdir, "true_Q", Q)
            _save(outdir, "true_A", A)
            for xi in cfg.Xset:
                X, noisyX = si.generate_trajectory(
                    rng, d, A, float(cfg.h), int(cfg.N), float(cfg.snr)
                )
                _save(outdir, f"X_{xi}", X)
                _save(outdir, f"noisyX_{xi}", noisyX)
            m = sum(2 if int(r[0]) in (0, 1) else 1 for r in np.atleast_2d(constset))
            _save(outdir, "initineqLagmult", np.ones(m))
            ralm_option = dict(cfg.get_path("solver_option.common") or {})
            for i, name in enumerate(cfg.initialpoints):
                iJ, iR, iQ, iA = si.generate_interior_initialpoint(
                    jax.random.fold_in(k2, i),
                    d,
                    constset,
                    scaling=scaling,
                    interior_scaling=float(cfg.get_path("interior_scaling", 0.95)),
                    ralm_option=ralm_option,
                )
                _save(outdir, f"initJ_{name}", iJ)
                _save(outdir, f"initR_{name}", iR)
                _save(outdir, f"initQ_{name}", iQ)
                _save(outdir, f"initA_{name}", iA)
            break
        except ValueError as e:  # retry loop (generator.py:18-55)
            logger.warning("retrying instance generation: %s", e)


def generate_low_rank(cfg):
    """Nonnegative low-rank approximation on FixedRankEmbedded
    (``problems/low_rank.py``; no reference counterpart — extension family)."""
    from riptrm_tpu.problems import low_rank

    outdir = cfg.get_path("output_path") or f"dataset/{cfg.problem_name}/{cfg.instance_name}"
    key = jax.random.PRNGKey(_instance_seed(cfg))
    kz, kp = jax.random.split(key)
    m, n, k = int(cfg.m), int(cfg.n), int(cfg.rank)
    data = low_rank.generate_instance(kz, m, n, k, float(cfg.noise))
    _save(outdir, "dim", [[m, n, k]])
    _save(outdir, "A", data["A"])
    lb = float(cfg.get_path("lb", 0.0) or 0.0)
    for i, name in enumerate(cfg.initialpoints):
        u0, s0, v0 = low_rank.generate_initialpoint(
            jax.random.fold_in(kp, i), m, n, k, lb=lb
        )
        _save(outdir, f"initU_{name}", u0)
        _save(outdir, f"initS_{name}", s0)
        _save(outdir, f"initV_{name}", v0)
    _save(outdir, "initineqLagmult", np.ones(m * n))


def generate_bounded_pca(cfg):
    """Bounded-coordinate PCA on Stiefel (``problems/bounded_pca.py``;
    extension family, no reference counterpart)."""
    from riptrm_tpu.problems import bounded_pca

    outdir = cfg.get_path("output_path") or f"dataset/{cfg.problem_name}/{cfg.instance_name}"
    key = jax.random.PRNGKey(_instance_seed(cfg))
    kz, kp = jax.random.split(key)
    n, p = int(cfg.dim), int(cfg.p)
    data = bounded_pca.generate_instance(kz, n, float(cfg.snr), float(cfg.delta))
    bound = float(cfg.get_path("bound", 0.8) or 0.8)
    _save(outdir, "dim", [[n, p]])
    _save(outdir, "Z", data["Z"])
    for i, name in enumerate(cfg.initialpoints):
        x0 = bounded_pca.generate_initialpoint(
            jax.random.fold_in(kp, i), n, p, bound=bound
        )
        _save(outdir, f"initx_{name}", x0)
    _save(outdir, "initineqLagmult", np.ones(2 * n * p))


GENERATORS = {
    "NonnegPCA": generate_nonneg_pca,
    "Rosenbrock": generate_rosenbrock,
    "StableIdentification": generate_stable_identification,
    "LowRank": generate_low_rank,
    "BoundedPCA": generate_bounded_pca,
}


def main(argv=None):
    argv = list(sys.argv[1:] if argv is None else argv)
    from riptrm_tpu.experiment.cfg import maybe_help

    maybe_help(argv, __doc__)
    logging.basicConfig(level=logging.INFO, format="[%(asctime)s][%(name)s] %(message)s")
    multirun = False
    config_path = None
    overrides = []
    it = iter(argv)
    for a in it:
        if a in ("-m", "--multirun"):
            multirun = True
        elif a == "--config":
            config_path = next(it)
        elif a == "--problem":
            config_path = f"configs/{next(it)}/config_dataset.yaml"
        else:
            overrides.append(a)
    if config_path is None:
        raise SystemExit("usage: generate (--config PATH | --problem NAME) [-m] [key=value ...]")
    # Generation runs on the CPU backend by design: the same seed must give
    # bit-identical instances on every machine, matching the shipped
    # dataset/ CSVs (device RNG lowering and reduction order differ).
    from riptrm_tpu.config import setup

    setup(cpu=True)
    cfgs = sweep_configs(config_path, overrides) if multirun else [load_config(config_path, overrides)]
    for cfg in cfgs:
        logger.info("Generating %s instance %s", cfg.problem_name, cfg.instance_name)
        GENERATORS[cfg.problem_name](cfg)


if __name__ == "__main__":
    main()
