"""Plain timing of RIPTRM's hot path on one GPU: NonnegPCA n=1000, float32.

    python bench.py

Each measurement is compiled first (reported as ``compile_s``), then
timed on the host clock over repeated calls that each end in
``block_until_ready``:

1. chained barrier-Hessian matvecs (the tCG loop's hot op) in one jit;
2. a batched B=16 RIPTRM tCG sweep (``parallel.sweep.batched_riptrm_solve``);
3. one compiled full solve (``RIPTRM.solve_compiled``).

``vs_baseline`` divides the matvec rate by the same chained matvec in
NumPy on the host CPU, the reference's substrate (SURVEY §2).  Prints ONE
JSON line naming the card and its power limit; exits non-zero without a
GPU.
"""

from __future__ import annotations

import json
import time

import numpy as np

from riptrm_tpu.utils.devices import card_identity, require_gpus

N = 1000
CHAIN = 4096
BATCH = 16
SOLVE_STEPS = 400
REPS = 5
PRECISION = "highest"


def timed(fn, *args, reps=REPS):
    """(compile_s, median run_s) of ``jax.jit(fn)`` at ``args``."""
    import jax

    t0 = time.perf_counter()
    compiled = jax.jit(fn).lower(*args).compile()
    compile_s = time.perf_counter() - t0
    ts = []
    for _ in range(reps):
        t0 = time.perf_counter()
        jax.block_until_ready(compiled(*args))
        ts.append(time.perf_counter() - t0)
    return compile_s, float(np.median(ts))


def main():
    devs = require_gpus(prog="bench")
    import jax
    import jax.numpy as jnp

    from riptrm_tpu.config import setup
    from riptrm_tpu.experiment.chip_sweep import build_sweep, f32_sweep_option
    from riptrm_tpu.parallel.sweep import batched_riptrm_solve, init_state_from
    from riptrm_tpu.solvers.riptrm import RIPTRM, _barrier_ops

    setup(x64=False)
    jax.config.update("jax_default_matmul_precision", PRECISION)
    problem, xs0, ys0 = build_sweep("NonnegPCA", N, BATCH, 0,
                                    matmul_precision=PRECISION)
    option = f32_sweep_option(problem)
    solver = RIPTRM(option)
    st0 = init_state_from(problem, solver.option, xs0[0], ys0[0])
    extras = {}

    # 1. chained barrier-Hessian matvecs
    def chain(v0):
        _, hw, _ = _barrier_ops(problem, st0.x, st0.y, st0.mu)

        def body(v, _):
            w = hw(v)
            return w / jnp.linalg.norm(w), ()

        return jax.lax.scan(body, v0, None, length=CHAIN)[0]

    v0 = problem.manifold.proj(st0.x, jnp.ones_like(st0.x))
    c_chain, t_chain = timed(chain, v0)
    matvecs_per_s = CHAIN / t_chain

    # NumPy host baseline of the same matvec (slack = x for NonnegPCA)
    zs = np.asarray(problem.structure["Zs"], np.float64)
    x, y = np.asarray(st0.x, np.float64), np.asarray(st0.y, np.float64)
    eg = -2.0 * zs @ x
    v = np.asarray(v0, np.float64)

    def hw_np(dx):
        eh = -2.0 * zs @ dx
        rh = eh - np.dot(x, eh) * x - np.dot(x, eg) * dx
        w = y * dx / x
        return rh + w - np.dot(x, w) * x

    t0 = time.perf_counter()
    for _ in range(64):
        v = hw_np(v)
        v = v / np.linalg.norm(v)
    np_matvecs_per_s = 64 / (time.perf_counter() - t0)
    extras.update(chain_compile_s=c_chain, numpy_host_matvecs_per_s=np_matvecs_per_s)

    # 2. batched sweep
    bsolve = batched_riptrm_solve(problem, option, max_steps=SOLVE_STEPS)
    c_b, t_b = timed(bsolve, xs0, ys0)
    _, ks, res = jax.block_until_ready(bsolve(xs0, ys0))
    extras.update(
        batch16_compile_s=c_b,
        batch16_solves_per_s=BATCH / t_b,
        batch16_median_residual=float(np.median(np.asarray(res))),
        batch16_max_steps=int(np.max(np.asarray(ks))),
    )

    # 3. one compiled full solve
    solve = solver.solve_compiled(problem, SOLVE_STEPS)
    c_s, t_s = timed(solve, st0)
    state, k = jax.block_until_ready(solve(st0))
    extras.update(solve_compile_s=c_s, solve_s=t_s, solve_inner_steps=int(k),
                  solve_outer_iters=int(state.outer_iter))

    print(json.dumps({
        "metric": "riptrm_tcg_matvecs_per_sec_nonnegpca_n1000",
        "value": matvecs_per_s,
        "unit": "matvec/s",
        "vs_baseline": matvecs_per_s / np_matvecs_per_s,
        "device": {"platform": devs[0].platform, "kind": devs[0].device_kind,
                   "count": len(devs)},
        "card": card_identity(),
        "precision": PRECISION,
        "extras": extras,
    }), flush=True)


if __name__ == "__main__":
    main()
