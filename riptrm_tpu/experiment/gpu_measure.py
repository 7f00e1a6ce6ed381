"""GPU measurements beside the smoke run: matmul precision and XLA tCG cost.

    python -m riptrm_tpu.experiment.gpu_measure DIR

1. What float32 matmuls compute at each ``jax.default_matmul_precision``
   ('default', 'high', 'highest'): the precision fields of the compiled
   GEMMs and the relative error of a [n, n] x [n, B] product against a
   float64 product.
2. The phase-2 NonnegPCA sweep at each precision (residuals, times).
3. For NonnegPCA n=1000 and BoundedPCA St(128,8), both at B=128: the
   sweep's wall time and device idle share from a profiler trace, and the
   XLA tCG (``ops/tcg.py``) per-iteration wall and device time at the
   sweep's final points — the numbers a fused GPU tCG kernel must beat.

Writes ``DIR/measure.json`` and the traces under ``DIR``; prints the
card, then the record as one JSON line.  Exits non-zero without a GPU.
"""

from __future__ import annotations

import argparse
import glob
import json
import os
import re
import time

import numpy as np

PRECISIONS = ("default", "high", "highest")
_WINDOW = "measure_window"


def interval_union_ns(intervals) -> int:
    """Total length covered by [start, end) intervals."""
    total, cur_s, cur_e = 0, None, None
    for s, e in sorted(intervals):
        if cur_e is None or s > cur_e:
            if cur_e is not None:
                total += cur_e - cur_s
            cur_s, cur_e = s, e
        else:
            cur_e = max(cur_e, e)
    if cur_e is not None:
        total += cur_e - cur_s
    return total


def device_busy(trace_dir: str) -> dict:
    """Reduce the newest trace under ``trace_dir``: the host span of the
    ``measure_window`` annotation, and the union of GPU activity (kernels
    and copies on the ``Stream`` lines) inside it."""
    from jax.profiler import ProfileData

    paths = sorted(glob.glob(f"{trace_dir}/plugins/profile/*/*.xplane.pb"))
    if not paths:
        raise FileNotFoundError(f"no trace under {trace_dir}")
    data = ProfileData.from_file(paths[-1])
    window = None
    per_line, kernels, stream = {}, {}, []
    for plane in data.planes:
        if plane.name.startswith("/host"):
            for line in plane.lines:
                for ev in line.events:
                    if ev.name == _WINDOW:
                        window = (ev.start_ns, ev.start_ns + ev.duration_ns)
        if not plane.name.startswith("/device:GPU"):
            continue
        for line in plane.lines:
            ivs = [(ev.start_ns, ev.start_ns + ev.duration_ns) for ev in line.events]
            per_line[f"{plane.name}/{line.name}"] = interval_union_ns(ivs) / 1e9
            if line.name.startswith("Stream"):
                stream.extend(ivs)
                for ev in line.events:
                    k = kernels.setdefault(ev.name, [0, 0.0])
                    k[0] += 1
                    k[1] += ev.duration_ns / 1e9
    if window is None:
        raise ValueError(f"no {_WINDOW} annotation in {paths[-1]}")
    lo, hi = window
    clipped = [(max(s, lo), min(e, hi)) for s, e in stream if e > lo and s < hi]
    busy = interval_union_ns(clipped) / 1e9
    span = (hi - lo) / 1e9
    top = sorted(kernels.items(), key=lambda kv: -kv[1][1])[:10]
    return {
        "window_s": span,
        "device_busy_s": busy,
        "idle_share": 1.0 - busy / span if span > 0 else None,
        "stream_events": len(stream),
        "busy_s_by_line": per_line,
        "top_kernels": [
            {"name": n[:160], "count": c, "total_s": t} for n, (c, t) in top
        ],
        "xplane": paths[-1],
    }


def traced(fn, trace_dir: str):
    """Run ``fn()`` once under the profiler inside a ``measure_window``
    annotation; returns (output, wall_s, device_busy record)."""
    import jax

    with jax.profiler.trace(trace_dir):
        with jax.profiler.TraceAnnotation(_WINDOW):
            t0 = time.perf_counter()
            out = jax.block_until_ready(fn())
            wall = time.perf_counter() - t0
    return out, wall, device_busy(trace_dir)


def hlo_precision_fields(hlo_text: str) -> list:
    """Distinct precision settings of the GEMMs/dots in compiled HLO."""
    found = set()
    for pat in (r'"operand_precision":\[[^\]]*\]', r'"algorithm":"[A-Z0-9_]+"',
                r"operand_precision=\{[^}]*\}", r"algorithm=[a-z0-9_]+",
                r'custom_call_target="[^"]*(?:gemm|matmul)[^"]*"'):
        found.update(re.findall(pat, hlo_text))
    return sorted(found)


def matmul_precision_probe(n: int = 1000, b: int = 128) -> dict:
    import jax
    import jax.numpy as jnp

    rng = np.random.default_rng(0)
    a = rng.standard_normal((n, n)).astype(np.float32)
    v = rng.standard_normal((n, b)).astype(np.float32)
    ref = a.astype(np.float64) @ v.astype(np.float64)
    out = {}
    for p in PRECISIONS:
        f = jax.jit(lambda x, y, p=p: jnp.matmul(x, y, precision=p))
        compiled = f.lower(a, v).compile()
        got = np.asarray(compiled(jnp.asarray(a), jnp.asarray(v)), np.float64)
        out[p] = {
            "rel_error": float(np.linalg.norm(got - ref) / np.linalg.norm(ref)),
            "hlo_precision": hlo_precision_fields(compiled.as_text()),
        }
    return out


def precision_sweep(precision: str, problem_name="NonnegPCA", size=1000,
                    batch=128, max_steps=400, reps=3) -> dict:
    """The float32 RIPTRM tCG sweep at one matmul precision: host-clock
    time per sweep, steps, and the device and CPU-x64 median residuals."""
    import jax

    from riptrm_tpu.experiment.chip_sweep import (
        build_sweep,
        cpu_x64_residuals,
        f32_sweep_option,
    )
    from riptrm_tpu.parallel.sweep import batched_riptrm_solve

    with jax.enable_x64(False), jax.default_matmul_precision(precision):
        problem, xs0, ys0 = build_sweep(
            problem_name, size, batch, 0, matmul_precision=precision
        )
        t0 = time.perf_counter()
        sweep = jax.jit(batched_riptrm_solve(
            problem, f32_sweep_option(problem), max_steps
        )).lower(xs0, ys0).compile()
        compile_s = time.perf_counter() - t0
        run_s = []
        for _ in range(reps):
            t0 = time.perf_counter()
            states, ks, res = jax.block_until_ready(sweep(xs0, ys0))
            run_s.append(time.perf_counter() - t0)
    res_cpu = cpu_x64_residuals(problem_name, size, batch, 0, states.x, states.y)
    sec = float(np.median(run_s))
    return {
        "s_per_sweep": sec, "solves_per_s": batch / sec,
        "compile_s": compile_s, "max_steps_taken": int(np.max(ks)),
        "median_residual_device": float(np.median(res)),
        "median_residual_cpu_x64": float(np.median(res_cpu)),
    }


def sweep_and_tcg(problem_name, size, batch, precision, trace_dir,
                  max_steps=400):
    """Traced batched sweep, then the traced XLA tCG at its final points
    (kappa = 0 and an unreachable radius, so each lane iterates until
    negative curvature, a model increase or dim iterations)."""
    import jax

    from riptrm_tpu.experiment.chip_sweep import build_sweep, f32_sweep_option
    from riptrm_tpu.ops.tcg import truncated_cg
    from riptrm_tpu.parallel.sweep import batched_riptrm_solve
    from riptrm_tpu.solvers.riptrm import _barrier_ops

    with jax.enable_x64(False), jax.default_matmul_precision(precision):
        problem, xs0, ys0 = build_sweep(
            problem_name, size, batch, 0, matmul_precision=precision
        )
        sweep = jax.jit(batched_riptrm_solve(
            problem, f32_sweep_option(problem), max_steps
        )).lower(xs0, ys0).compile()
        states, ks, _ = jax.block_until_ready(sweep(xs0, ys0))
        _, sweep_wall, sweep_busy = traced(
            lambda: sweep(xs0, ys0), f"{trace_dir}/sweep"
        )
        man = problem.manifold

        def one(x, y, mu):
            _, hw, cx = _barrier_ops(problem, x, y, mu)
            _, _, j, code = truncated_cg(man, x, hw, cx, 1e15, kappa=0.0,
                                         maxinner=man.dim)
            return j, code

        tcg = jax.jit(jax.vmap(one)).lower(states.x, states.y, states.mu).compile()
        jax.block_until_ready(tcg(states.x, states.y, states.mu))
        (iters, codes), tcg_wall, tcg_busy = traced(
            lambda: tcg(states.x, states.y, states.mu), f"{trace_dir}/tcg"
        )
    lockstep = int(np.max(np.asarray(iters)))
    return {
        "problem": problem_name, "size": size, "batch": batch,
        "precision": precision,
        "sweep": {"wall_s": sweep_wall, "max_steps_taken": int(np.max(ks)),
                  **sweep_busy},
        "tcg": {
            "lockstep_iterations": lockstep,
            "stop_codes": np.bincount(np.asarray(codes), minlength=6).tolist(),
            "wall_s": tcg_wall,
            "wall_s_per_iteration": tcg_wall / lockstep,
            "device_s_per_iteration": tcg_busy["device_busy_s"] / lockstep,
            **tcg_busy,
        },
    }


def measure(out_dir: str) -> dict:
    os.makedirs(out_dir, exist_ok=True)
    rec = {"matmul": matmul_precision_probe()}
    rec["nonnegpca_sweep_by_precision"] = {
        p: precision_sweep(p) for p in PRECISIONS
    }
    rec["traces"] = {
        "nonnegpca_n1000_b128": sweep_and_tcg(
            "NonnegPCA", 1000, 128, "highest", f"{out_dir}/nonnegpca"
        ),
        "boundedpca_st128x8_b128": sweep_and_tcg(
            "BoundedPCA", 128, 128, "highest", f"{out_dir}/boundedpca"
        ),
    }
    with open(f"{out_dir}/measure.json", "w") as f:
        json.dump(rec, f, indent=1, default=float)
    return rec


def main(argv=None):
    parser = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    parser.add_argument("out_dir", help="directory for measure.json and traces")
    args = parser.parse_args(argv)

    from riptrm_tpu.config import enable_compile_cache
    from riptrm_tpu.utils.devices import card_identity, require_gpus

    require_gpus(prog="gpu_measure")
    enable_compile_cache()
    print(json.dumps({"card": card_identity()}), flush=True)
    rec = measure(args.out_dir)
    for t in rec["traces"].values():  # the per-line and kernel tables stay in the file
        for part in ("sweep", "tcg"):
            t[part] = {k: v for k, v in t[part].items()
                       if k not in ("busy_s_by_line", "top_kernels")}
    print(json.dumps(rec, default=float), flush=True)


if __name__ == "__main__":
    main()
