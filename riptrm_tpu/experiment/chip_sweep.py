"""Batched multi-start sweep throughput for any problem family.

The reference parallelizes its experimental sweep (instances x initial
points) as independent Hydra-multirun OS processes (``README.md:72-107``);
here the sweep is a batch axis of ONE compiled solve (SURVEY §2.3).  This
CLI measures that sweep's throughput on the default device (the GPU where
one is present) for a generated instance of any problem family at any size:

    python -m riptrm_tpu.experiment.chip_sweep --problem NonnegPCA \
        --size 1000 --batch 128
    python -m riptrm_tpu.experiment.chip_sweep --problem StableIdentification \
        --size 16 --batch 8

Methodology: data generation and the feasible-interior start search run
on the host CPU backend, so a generated instance is bit-identical on every
machine and matches the committed ``dataset/_cache`` payloads; the batched
solve runs on the default device.  The sweep is compiled ahead of time
(reported as ``compile_s``) and then timed on the host clock, each call
ending in ``block_until_ready``.

f32 notes: forcing floors are lifted to the f32-appropriate values, and the
default matmul precision is an explicit ``--precision`` choice: f32 matmuls
at reduced precision (TF32 on the GPU's tensor cores) carry a noise floor
that can stall the inner loop at tight tolerances.
"""

from __future__ import annotations

import argparse
import json
import time

import numpy as np

from riptrm_tpu.utils.devices import local_cpu


# ----------------------------------------------------------------------
# Generated-instance cache
#
# Host-side generation can dominate a run (a d=32 StableIdentification
# batch's lsq interior-start search runs 1000 CG iterations per lane, for
# minutes against a seconds-long sweep).  The
# expensive part is pure numpy payload, so it caches as one npz per
# (problem, size, seed) keyed file; batch-stacked keys carry a ``b_``
# prefix and a cache written at batch B serves any request with
# batch' <= B by slicing.  The reference persists generated data the
# same way (``dataset_generator.py:39-50`` writes CSVs under dataset/).
# ----------------------------------------------------------------------
def _cache_dir():
    import os
    import pathlib

    env = os.environ.get("RIPTRM_CACHE_DIR")  # tests point this at a tmpdir
    if env:
        return pathlib.Path(env)
    return pathlib.Path(__file__).resolve().parents[2] / "dataset" / "_cache"


def _cache_load(problem_name: str, size: int, batch: int, seed: int):
    """Return a payload dict with batch axes sliced to ``batch``, or None."""
    d = _cache_dir()
    if not d.is_dir():
        return None
    best = None
    prefix = f"{problem_name}_s{size}_seed{seed}_b"
    for f in d.glob(f"{prefix}*.npz"):
        try:
            b = int(f.stem[len(prefix):])
        except ValueError:
            continue
        if b >= batch and (best is None or b < best[0]):
            best = (b, f)
    if best is None:
        return None
    with np.load(best[1]) as z:
        return {
            k: (z[k][:batch] if k.startswith("b_") else z[k]) for k in z.files
        }


def _cache_store(problem_name: str, size: int, batch: int, seed: int, payload):
    import os
    import tempfile

    d = _cache_dir()
    d.mkdir(parents=True, exist_ok=True)
    path = d / f"{problem_name}_s{size}_seed{seed}_b{batch}.npz"
    fd, tmp = tempfile.mkstemp(dir=d, suffix=".npz.tmp")
    try:
        with os.fdopen(fd, "wb") as fh:
            np.savez(fh, **payload)
        os.replace(tmp, path)  # atomic: concurrent readers never see a torn file
    except BaseException:
        if os.path.exists(tmp):
            os.unlink(tmp)
        raise


def build_sweep(problem_name: str, size: int, batch: int, seed: int = 0,
                cache: bool = True, matmul_precision: str | None = "high",
                dtype=None):
    """Generate an instance + a stacked batch of initial points on the host.

    Returns (problem, xs0, ys0) where xs0/ys0 carry a leading batch axis
    (pytree leaves stacked), built OUTSIDE the CPU context so the problem's
    arrays live on the default device.  ``cache=True`` reuses (and
    persists) the host-generated numpy payload under ``dataset/_cache``.
    ``matmul_precision`` is NonnegPCA's matvec precision (None: the
    backend default); ``dtype`` defaults to float32 (float64 rebuilds the
    same instance for an x64 reference).
    """
    payload = _cache_load(problem_name, size, batch, seed) if cache else None
    if payload is None:
        payload = _generate_payload(problem_name, size, batch, seed)
        if cache:
            _cache_store(problem_name, size, batch, seed, payload)
    return _build_from_payload(
        problem_name, size, batch, payload, matmul_precision, dtype
    )


def _rosenbrock_k(n: int) -> int:
    """Grassmann frame width: the reference ships k=3 at its small n
    (``Rosenbrock/coordinator.py:33-71``); the scaled-up instances
    (n >= 256) use k=8 so the QR/polar retraction and the [n, k] tangent
    algebra carry real matrix width."""
    return 8 if n >= 256 else min(3, n - 1)


def _generate_payload(problem_name: str, size: int, batch: int, seed: int):
    """Host-side generation -> flat dict of numpy arrays (the cacheable
    part).  Batch-stacked keys carry the ``b_`` prefix (axis 0 = lane)."""
    import jax
    import jax.numpy as jnp

    # Every draw runs on the HOST backend: the same seed must give the same
    # bits on any machine, matching the committed dataset/_cache payloads.
    cpu = local_cpu()
    with jax.default_device(cpu):
        key = jax.random.PRNGKey(seed)

    if problem_name == "NonnegPCA":
        from riptrm_tpu.problems import nonneg_pca

        k1, k2 = jax.random.split(key)
        with jax.default_device(cpu):
            data = nonneg_pca.generate_instance(k1, size)
            z_np = np.asarray(data["Z"])
            xs0 = np.abs(
                np.asarray(jax.random.normal(jax.device_put(k2, cpu),
                                             (batch, size)))
            )
        xs0 = xs0 / np.linalg.norm(xs0, axis=1, keepdims=True)
        return {"Z": z_np, "b_xs0": xs0}

    if problem_name == "StableIdentification":
        from riptrm_tpu.problems import stable_identification as si

        d = size
        rng = np.random.default_rng(seed)
        with jax.default_device(cpu):
            _, _, _, true_a = si.generate_true_system(key, d)
            constset = si.generate_constraints(
                rng, d, true_a, oneboxratio=0.2, twoboxratio=0.1
            )
            trajs = [
                si.generate_trajectory(rng, d, true_a, h=0.02, n_steps=20, snr=10)[1]
                for _ in range(5)
            ]
            starts = []
            for i in range(batch):
                key, sub = jax.random.split(key)
                # the scalable target-matching search: the reference's
                # RALM feasibility loop stops finding the nonconvex
                # annulus-constrained interior beyond d~5
                j_m, r_m, q_m, _ = si.generate_interior_initialpoint_lsq(
                    sub, d, constset
                )
                starts.append((j_m, r_m, q_m))
        return {
            "trajs": np.stack(trajs),
            "constset": np.asarray(constset),
            "b_J": np.stack([s_[0] for s_ in starts]),
            "b_R": np.stack([s_[1] for s_ in starts]),
            "b_Q": np.stack([s_[2] for s_ in starts]),
        }

    if problem_name == "Rosenbrock":
        from riptrm_tpu.problems import rosenbrock

        n = size
        if n < 2:
            raise ValueError(
                "Rosenbrock needs --size >= 2 (Grassmann(n, k) with k < n "
                "has dimension k*(n-k) = 0 otherwise)"
            )
        k = _rosenbrock_k(n)
        problem = rosenbrock.make_problem(n, k, dtype=jnp.float32)
        # The reference's Rosenbrock start is the single deterministic
        # |I[:, :k]| (coordinator.py:78-84); the sweep batches small
        # tangent retractions of it — on-manifold, and with step 5e-3 the
        # entries stay above the -0.01 constraint bound (feasible).
        man = problem.manifold
        x0 = problem.x0
        starts = []
        with jax.default_device(cpu):
            x0c = jax.device_put(x0, cpu)
            for i in range(batch):
                key, sub = jax.random.split(jax.device_put(key, cpu))
                v = man.random_tangent(sub, x0c)
                starts.append(np.asarray(man.retract(x0c, 5e-3 * v)))
        return {"b_xs0": np.stack(starts)}

    if problem_name == "BoundedPCA":
        from riptrm_tpu.problems import bounded_pca

        if size < 3:
            raise ValueError(
                "BoundedPCA needs --size >= 3 (St(n, p) needs n > p >= 2)"
            )
        p = min(max(2, size // 16), size - 1)  # St(n, p) with a small frame
        with jax.default_device(cpu):
            # Distinct upfront subkeys: the instance key must not be reused
            # for starts, and the splits must run on the CPU backend.
            ks = jax.random.split(jax.device_put(key, cpu), batch + 1)
            data = bounded_pca.generate_instance(ks[0], size)
            z_np = np.asarray(data["Z"])
            starts = [
                bounded_pca.generate_initialpoint(ks[1 + i], size, p)
                for i in range(batch)
            ]
        return {"Z": z_np, "b_xs0": np.stack([np.asarray(s_) for s_ in starts])}

    if problem_name == "LowRank":
        from riptrm_tpu.problems import low_rank

        if size < 5:
            raise ValueError(
                "LowRank needs --size >= 5 (rank must be < min(m, n) for a "
                "genuine fixed-rank manifold)"
            )
        m, n, rank = size, max(2, size // 2), max(2, size // 8)
        rank = min(rank, n - 1, m - 1)
        with jax.default_device(cpu):
            ks = jax.random.split(jax.device_put(key, cpu), batch + 1)
            data = low_rank.generate_instance(ks[0], m, n, rank)
            a_np = np.asarray(data["A"])
            starts = [
                low_rank.generate_initialpoint(ks[1 + i], m, n, rank)
                for i in range(batch)
            ]
        return {
            "A": a_np,
            "b_U": np.stack([s_[0] for s_ in starts]),
            "b_S": np.stack([s_[1] for s_ in starts]),
            "b_V": np.stack([s_[2] for s_ in starts]),
        }

    raise ValueError(
        "chip_sweep supports NonnegPCA, StableIdentification, Rosenbrock, "
        f"BoundedPCA and LowRank; got {problem_name}"
    )


def _build_from_payload(problem_name: str, size: int, batch: int, payload,
                        matmul_precision: str | None = "high", dtype=None):
    """Construct (problem, xs0, ys0) from a (possibly cached) payload."""
    import jax.numpy as jnp

    dtype = jnp.float32 if dtype is None else dtype

    if problem_name == "NonnegPCA":
        from riptrm_tpu.problems import nonneg_pca

        xs0 = payload["b_xs0"]
        problem = nonneg_pca.make_problem(
            payload["Z"], xs0[0], dtype=dtype,
            matmul_precision=matmul_precision,
        )
        return (
            problem,
            jnp.asarray(xs0, dtype),
            jnp.ones((batch, size), dtype),
        )

    if problem_name == "StableIdentification":
        from riptrm_tpu.problems import stable_identification as si

        d = size
        starts = (payload["b_J"], payload["b_R"], payload["b_Q"])
        problem = si.make_problem(
            d, list(payload["trajs"]), payload["constset"],
            tuple(a[0] for a in starts), dtype=dtype,
        )
        xs0 = tuple(jnp.asarray(a, dtype) for a in starts)
        ys0 = jnp.ones((batch, problem.num_ineq), dtype)
        return problem, xs0, ys0

    if problem_name == "Rosenbrock":
        from riptrm_tpu.problems import rosenbrock

        n = size
        k = _rosenbrock_k(n)
        problem = rosenbrock.make_problem(n, k, dtype=dtype)
        xs0 = jnp.asarray(payload["b_xs0"], dtype)
        ys0 = jnp.ones((batch, problem.num_ineq), dtype)
        return problem, xs0, ys0

    if problem_name == "BoundedPCA":
        from riptrm_tpu.problems import bounded_pca

        xs0 = payload["b_xs0"]
        problem = bounded_pca.make_problem(
            payload["Z"], xs0[0], dtype=dtype
        )
        ys0 = jnp.ones((batch, problem.num_ineq), dtype)
        return problem, jnp.asarray(xs0, dtype), ys0

    if problem_name == "LowRank":
        from riptrm_tpu.problems import low_rank

        starts = (payload["b_U"], payload["b_S"], payload["b_V"])
        problem = low_rank.make_problem(
            payload["A"], tuple(a[0] for a in starts), dtype=dtype
        )
        xs0 = tuple(jnp.asarray(a, dtype) for a in starts)
        ys0 = jnp.ones((batch, problem.num_ineq), dtype)
        return problem, xs0, ys0

    raise ValueError(f"unknown problem family {problem_name}")


def f32_sweep_option(problem, maxiter: int = 60, tolresid: float = 3e-4,
                     exact: bool = False) -> dict:
    """RIPTRM options for an f32 batched sweep: the reference's 1e-14
    forcing floors assume f64, so they are lifted to what f32 can reach.
    The complementarity criterion is a 2-norm over all m constraints, so
    its reachable floor grows like sqrt(m); 2e-4 was calibrated at m=200
    (NonnegPCA n=200).

    The ared/pred regularization drops from the reference's 1e3 ulps of
    |phi| to 4.  It must sit above the rounding noise of the f32 ared
    (measured 1-3 ulps of |phi|) and below the smallest predicted
    reduction that still carries information.  In f32, 1e3 ulps is
    1.2e-4 |phi|: 3.9e-3 on BoundedPCA St(128, 8) (|phi| ~ 33), above the
    ~5e-4 predicted reductions of its first barrier level, so ared/pred
    read ~0.87 even for steps that raised phi, the radius never shrank and
    about half the lanes churned at mu = 0.1.  Below 3 ulps, noise-driven
    rejections collapse StableIdentification's radius until its steps
    no longer move x.
    """
    import jax.numpy as jnp

    compl_floor = 2e-4 * max(1.0, (problem.num_ineq / 200.0) ** 0.5)
    option = {
        "maxiter": maxiter,
        "tolresid": tolresid,
        "TRS_solver": "Exact_RepMat" if exact else "tCG",
        "second_order_stationarity": exact,
        "reduction_regularization": 4.0,
        "forcing_function_Lagrangian": lambda mu: jnp.maximum(mu, 1e-4),
        "forcing_function_complementarity": (
            lambda mu: jnp.maximum(1e-3 * mu, compl_floor)
        ),
    }
    if exact:
        option["forcing_function_second_order"] = (
            lambda mu: jnp.maximum(mu, 1e-4)
        )
    return option


def cpu_x64_residuals(problem_name, size, batch, seed, xs, ys):
    """KKT residual of every lane's (x, y), re-evaluated in float64 on the
    host CPU backend at 'highest' matmul precision, on the same instance
    rebuilt from its generated payload."""
    import jax
    import jax.numpy as jnp

    from riptrm_tpu.ops.kkt import compute_residual

    with (jax.enable_x64(True), jax.default_device(local_cpu()),
          jax.default_matmul_precision("highest")):
        problem, _, _ = build_sweep(
            problem_name, size, batch, seed, matmul_precision="highest",
            dtype=jnp.float64,
        )
        xs64 = jax.tree.map(lambda a: jnp.asarray(np.asarray(a), jnp.float64), xs)
        ys64 = jnp.asarray(np.asarray(ys), jnp.float64)
        z = jnp.zeros((0,), jnp.float64)
        res = jax.jit(jax.vmap(
            lambda x, y: compute_residual(problem, x, y, z)[0]
        ))(xs64, ys64)
        return np.asarray(res)


def measure_sweep(problem, xs0, ys0, option, max_steps, reps=3,
                  solver="RIPTRM", bsolve=None):
    """Host-clock throughput of the batched compiled solver sweep.

    The sweep is compiled ahead of time, then run ``reps`` times; each
    timed call ends in ``block_until_ready``.  Returns (sec_per_sweep,
    residuals, compile_s, k_max) with sec_per_sweep the median over the
    reps and k_max the largest per-lane step count.  ``bsolve`` overrides
    the solver construction with a prebuilt (xs, ys) -> (states, ks, res)
    callable (the staged-precision path builds its own two-phase program).
    """
    import jax

    from riptrm_tpu.parallel.sweep import batched_riptrm_solve, batched_solver_sweep

    if bsolve is not None:
        pass
    elif solver == "RIPTRM":
        bsolve = batched_riptrm_solve(problem, option, max_steps=max_steps)
    else:
        inner = batched_solver_sweep(problem, solver, option, max_steps=max_steps)

        def bsolve(xs, ys):
            _, _, ks, res = inner(xs, ys)
            return None, ks, res

    t0 = time.perf_counter()
    compiled = jax.jit(lambda xs, ys: bsolve(xs, ys)[1:]).lower(xs0, ys0).compile()
    compile_s = time.perf_counter() - t0
    ts = []
    for _ in range(reps):
        t0 = time.perf_counter()
        ks, res = jax.block_until_ready(compiled(xs0, ys0))
        ts.append(time.perf_counter() - t0)
    return (
        float(np.median(ts)), np.asarray(res), compile_s,
        int(np.max(np.asarray(ks))),
    )


def main(argv=None):
    parser = argparse.ArgumentParser(description=__doc__)
    parser.add_argument("--problem", default="NonnegPCA")
    parser.add_argument("--size", type=int, default=1000,
                        help="n for NonnegPCA, d for StableIdentification")
    parser.add_argument("--batch", type=int, default=16)
    parser.add_argument("--max-steps", type=int, default=400)
    parser.add_argument("--maxiter", type=int, default=60,
                        help="outer-iteration cap per lane")
    parser.add_argument("--tolresid", type=float, default=3e-4)
    parser.add_argument("--compensated", action="store_true",
                        help="compensated (double-word f32) complementarity "
                             "norm + ared barrier sum (ops/compensated.py) "
                             "— floor-measurement mode")
    parser.add_argument("--solver", default="RIPTRM",
                        choices=["RIPTRM", "RIPM", "RSQO", "RALM"])
    parser.add_argument("--exact", action="store_true",
                        help="RIPTRM exact mode: per-lane Hw materialization "
                             "+ batched-eigh TRS with the in-loop "
                             "second-order stationarity criterion")
    parser.add_argument(
        "--rsqo-qp-mode", default="reghess_shift",
        choices=["reghess", "reghess_shift", "reghess_operator", "eye"],
        help="RSQO Hessian regularization: 'reghess_shift' (default here) "
             "replaces the reference's per-step eigenvalue-clamp eigh with a "
             "certified diagonal shift (identical whenever the Hessian is "
             "already sufficiently PD); 'reghess' is the reference-exact "
             "clamp")
    parser.add_argument(
        "--rsqo-linear-solver", default="schulz",
        choices=["chol", "lu", "schulz", "schulz_polish"],
        help="RSQO QP Newton-system solve: 'schulz' (default here: "
             "factorization-free Newton-Schulz inverse maintenance, pure "
             "batched matmuls), 'chol' (batched Cholesky), 'lu' "
             "(deep-parity)")
    parser.add_argument("--precision", choices=["high", "highest"],
                        default=None,
                        help="default matmul precision (default: 'highest' "
                             "for BoundedPCA, whose inner loop cannot "
                             "satisfy the complementarity criterion under "
                             "reduced-precision matvecs, 'high' for "
                             "everything else)")
    parser.add_argument("--staged-precision", action="store_true",
                        help="two-phase staged matvec precision (RIPTRM + "
                             "NonnegPCA): phase 1 runs the --precision "
                             "program to its f32 floor, phase 2 CONTINUES "
                             "all lanes under a 'highest' program with 10x "
                             "tighter forcing floors and --staged-tolresid; "
                             "reports both phases' residuals")
    parser.add_argument("--staged-tolresid", type=float, default=3e-6,
                        help="phase-2 residual target for --staged-precision")
    parser.add_argument("--staged-compact", action="store_true",
                        help="with --staged-precision: run phase 2 as "
                             "host-driven segments with converged-lane "
                             "compaction (power-of-two buckets)")
    parser.add_argument("--staged-segment-steps", type=int, default=100,
                        help="phase-2 segment length for --staged-compact")
    parser.add_argument("--stall-window", type=int, default=None,
                        help="freeze a sweep lane whose best residual has "
                             "not improved 1%% in this many steps (lockstep "
                             "throughput guard: one floor-stalled lane "
                             "otherwise burns every lane's full budget); "
                             "baseline-solver sweeps only")
    parser.add_argument("--certify", action="store_true",
                        help="post-hoc batched second-order certificates at "
                             "the sweep's final points (one vmapped "
                             "matrix-free Lanczos, parallel/sweep.py::"
                             "certify_second_order) — valid for problems "
                             "with AFFINE constraints (NonnegPCA, "
                             "BoundedPCA, Rosenbrock), where Hess g = 0 "
                             "makes the ratio-capped certificate "
                             "conservative; RIPTRM only")
    parser.add_argument("--option", action="append", default=[],
                        metavar="KEY=VALUE",
                        help="extra solver option override, repeatable "
                             "(bool/int/float parsed; e.g. --option "
                             "KrylovIterMethod=true for RIPM's matrix-free "
                             "CR condensed solve)")
    parser.add_argument("--seed", type=int, default=0)
    args = parser.parse_args(argv)
    option_overrides = {}
    for kv in args.option:
        k, _, v = kv.partition("=")
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
                    option_overrides[k] = v
    if args.certify and (
        args.solver != "RIPTRM" or args.problem == "StableIdentification"
    ):
        parser.error(
            "--certify needs RIPTRM final states and affine constraints "
            "(StableIdentification's annulus terminal duals make any "
            "terminal curvature bound vacuous — see protocol_speedrun)"
        )
    if args.precision is None:
        args.precision = "highest" if args.problem == "BoundedPCA" else "high"
    if args.exact and args.solver != "RIPTRM":
        parser.error(
            "--exact selects RIPTRM's Exact_RepMat mode; the baseline "
            "solvers ignore those options, and reporting mode='exact' for "
            "them would fabricate benchmark rows"
        )
    if args.staged_precision and (
        args.solver != "RIPTRM" or args.exact or args.problem != "NonnegPCA"
    ):
        parser.error(
            "--staged-precision is the RIPTRM tCG NonnegPCA floor-chasing "
            "mode (phase 2 rebuilds the problem at matmul_precision="
            "'highest'; other problems take precision from the global flag)"
        )

    from riptrm_tpu.config import setup

    jax = setup(x64=False)
    jax.config.update("jax_default_matmul_precision", args.precision)
    import jax.numpy as jnp

    t0 = time.time()
    cache_hit = (
        _cache_load(args.problem, args.size, args.batch, args.seed) is not None
    )
    problem, xs0, ys0 = build_sweep(
        args.problem, args.size, args.batch, args.seed,
        matmul_precision=args.precision,
    )
    gen_s = time.time() - t0

    option = f32_sweep_option(problem, args.maxiter, args.tolresid, args.exact)
    option["compensated_reductions"] = args.compensated
    if args.solver == "RSQO":
        option["quadoptim_type"] = args.rsqo_qp_mode
        option["quadoptim_linear_solver"] = args.rsqo_linear_solver
    if args.stall_window is not None:
        option["sweep_stall_window"] = args.stall_window
    option.update(option_overrides)
    device = {
        "platform": jax.devices()[0].platform,
        "kind": jax.devices()[0].device_kind,
        "count": len(jax.devices()),
    }
    staged_extra = {}
    bsolve = None
    if args.staged_precision:
        from riptrm_tpu.problems import nonneg_pca
        from riptrm_tpu.parallel.sweep import staged_precision_riptrm_solve

        # Phase 2: same instance (structure carries the symmetrized Zs,
        # and cost/grad only ever use Zs) rebuilt with full-f32 matvecs,
        # floors dropped 10x, and a stall guard so floor-stalled lanes
        # don't burn the full budget in lockstep.
        problem_hi = nonneg_pca.make_problem(
            problem.structure["Zs"], np.asarray(xs0[0]),
            dtype=jnp.float32, matmul_precision="highest",
        )
        compl_floor_hi = 2e-5 * max(1.0, (problem.num_ineq / 200.0) ** 0.5)
        option_hi = option | {
            "tolresid": args.staged_tolresid,
            "forcing_function_Lagrangian": lambda mu: jnp.maximum(mu, 1e-5),
            "forcing_function_complementarity": (
                lambda mu: jnp.maximum(1e-3 * mu, compl_floor_hi)
            ),
            "sweep_stall_window": option.get("sweep_stall_window", 25),
        }
        if args.staged_compact:
            from riptrm_tpu.parallel.sweep import (
                staged_precision_riptrm_compacted,
            )

            run_compact = staged_precision_riptrm_compacted(
                problem, problem_hi, option, option_hi, args.max_steps,
                segment_steps=args.staged_segment_steps,
            )
            # warm (compiles phase 1 + the phase-2 bucket programs this
            # instance actually visits), then wall-clock the host loop,
            # whose per-segment host reads are part of the cost.
            run_compact(xs0, ys0)
            ts = []
            for _ in range(3):
                t0 = time.perf_counter()
                best, res1, segs = run_compact(xs0, ys0)
                ts.append(time.perf_counter() - t0)
            t_run = float(np.median(ts))
            out = {
                "problem": args.problem,
                "size": args.size,
                "batch": args.batch,
                "solver": "RIPTRM",
                "mode": "staged_precision_compacted",
                "point": "best",
                "segment_steps": args.staged_segment_steps,
                "solves_per_sec": args.batch / t_run,
                "sweep_ms": t_run * 1e3,
                "median_residual": float(np.median(best)),
                "max_residual": float(np.max(best)),
                "phase1_median_residual": float(np.median(res1)),
                "floor_improvement_x": float(
                    np.median(res1) / max(np.median(best), 1e-30)
                ),
                "segments_used": [int(s) for s in segs],
                "gen_s": gen_s,
                "cache_hit": cache_hit,
                "device": device,
            }
            print(json.dumps(out))
            return

        staged = staged_precision_riptrm_solve(
            problem, problem_hi, option, option_hi, args.max_steps
        )

        def bsolve(xs, ys):
            st, ks, res2, res1 = staged(xs, ys)
            return st, ks, res2

        # one un-timed call for the phase-1 floor report
        _, _, res2_probe, res1_probe = jax.tree.map(
            np.asarray, staged(xs0, ys0)
        )
        staged_extra = {
            "phase1_median_residual": float(np.median(res1_probe)),
            "phase1_max_residual": float(np.max(res1_probe)),
            "floor_improvement_x": float(
                np.median(res1_probe) / max(np.median(res2_probe), 1e-30)
            ),
        }

    per_sweep, res, compile_s, _ = measure_sweep(
        problem, xs0, ys0, option, max_steps=args.max_steps,
        solver=args.solver, bsolve=bsolve,
    )
    out = {
        "problem": args.problem,
        "size": args.size,
        "batch": args.batch,
        "solver": args.solver,
        "mode": (
            "staged_precision" if args.staged_precision
            else "exact" if args.exact else "tCG"
        ),
        # which iterate the residual columns score: RALM and the staged
        # continuation default to the best iterate, the rest to the final
        "point": (
            "best"
            if (
                args.staged_precision
                or option.get("keep_best_point", args.solver == "RALM")
            )
            else "final"
        ),
        "precision": args.precision,
        **staged_extra,
        **(
            {"rsqo_linear_solver": args.rsqo_linear_solver}
            if args.solver == "RSQO"
            else {}
        ),
        "solves_per_sec": args.batch / per_sweep,
        "sweep_ms": per_sweep * 1e3,
        "median_residual": float(np.median(res)),
        "max_residual": float(np.max(res)),
        "gen_s": gen_s,
        "cache_hit": cache_hit,
        "compile_s": compile_s,
        "device": device,
    }
    if args.certify:
        from riptrm_tpu.parallel.sweep import (
            batched_riptrm_solve,
            certify_second_order,
        )

        bsolve = batched_riptrm_solve(problem, option, max_steps=args.max_steps)
        states, _, _ = jax.block_until_ready(bsolve(xs0, ys0))
        t0 = time.perf_counter()
        mineigs = np.asarray(jax.block_until_ready(
            certify_second_order(problem, states.x, states.y, ratio_cap=1e8)
        ))
        out["certify_s"] = time.perf_counter() - t0
        out["certified_mineig_min"] = float(np.nanmin(mineigs))
        out["certified_mineig_median"] = float(np.nanmedian(mineigs))
        out["certified_lanes"] = int(np.isfinite(mineigs).sum())
    print(json.dumps(out))


if __name__ == "__main__":
    main()
