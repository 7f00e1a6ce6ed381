"""Deployable solver artifacts (serving path).

A production/serving process should not re-trace and re-lower the solver
on startup.  ``export_sweep`` serializes the fully-compiled batched solve
— problem data baked in as constants — to a StableHLO artifact via
``jax.export``; ``load_sweep`` deserializes and calls it with zero
tracing (and the XLA compile itself is covered by the persistent
compilation cache).  The reference has no deployment story at all (its
entry point re-imports and re-builds everything per Hydra job).

Artifact layout: ``<path>`` holds the serialized StableHLO blob,
``<path>.json`` a manifest (solver, shapes, dtypes, jax version) checked
on load.

Notes:
* the problem instance (e.g. the Z matrix) is a constant inside the
  artifact — one artifact serves one instance at a fixed batch size;
* ``platforms`` may name cross-platform lowering targets (e.g.
  ``["cuda", "cpu"]``) so a CPU build box can produce GPU artifacts.
"""

from __future__ import annotations

import json
import os
from typing import Optional, Sequence

import numpy as np


def _example_args(problem, batch: int):
    import jax
    import jax.numpy as jnp

    def batched(leaf):
        a = jnp.asarray(leaf)
        return jax.ShapeDtypeStruct((batch,) + a.shape, a.dtype)

    xs = jax.tree.map(batched, problem.x0)
    y = jnp.asarray(problem.y0)
    ys = jax.ShapeDtypeStruct((batch,) + y.shape, y.dtype)
    return xs, ys


def export_sweep(
    problem,
    solver_name: str,
    option: dict,
    path: str,
    *,
    batch: int,
    max_steps: int = 2000,
    platforms: Optional[Sequence[str]] = None,
) -> None:
    """Serialize the batched compiled solve for ``solver_name`` to ``path``.

    The artifact's callable signature is (xs0, ys0) -> (x, y, steps,
    residuals) with a leading batch axis of exactly ``batch``.
    """
    import jax
    from jax import export as jexport

    from riptrm_tpu.parallel.sweep import batched_solver_sweep

    fn = batched_solver_sweep(problem, solver_name, option, max_steps)
    xs, ys = _example_args(problem, batch)
    exp = jexport.export(fn, platforms=platforms)(xs, ys)
    blob = exp.serialize()

    os.makedirs(os.path.dirname(path) or ".", exist_ok=True)
    with open(path, "wb") as f:
        f.write(blob)
    manifest = {
        "solver": solver_name,
        "batch": batch,
        "max_steps": max_steps,
        "num_ineq": int(problem.num_ineq),
        "platforms": list(exp.platforms),
        "x_shapes": [list(l.shape) for l in jax.tree.leaves(xs)],
        "x_dtypes": [str(l.dtype) for l in jax.tree.leaves(xs)],
        "y_shape": list(ys.shape),
        "y_dtype": str(ys.dtype),
        "jax_version": jax.__version__,
    }
    with open(path + ".json", "w") as f:
        json.dump(manifest, f, indent=1)


def load_sweep(path: str):
    """Deserialize an exported sweep: returns (callable, manifest).

    The callable runs without any Python-level tracing of the solver;
    inputs are validated against the manifest first, so a wrong batch
    size or dtype fails with a clear message instead of an opaque
    StableHLO error.
    """
    import warnings

    import jax
    from jax import export as jexport

    with open(path, "rb") as f:
        exp = jexport.deserialize(f.read())
    manifest = {}
    if os.path.exists(path + ".json"):
        with open(path + ".json") as f:
            manifest = json.load(f)
        if manifest.get("jax_version") not in (None, jax.__version__):
            warnings.warn(
                f"artifact {path} was exported under jax "
                f"{manifest['jax_version']}; running under {jax.__version__}"
            )

    def run(xs0, ys0):
        if manifest:
            import jax as _jax

            leaves = _jax.tree.leaves(xs0)
            got = [list(np.shape(l)) for l in leaves] + [list(np.shape(ys0))]
            want = manifest["x_shapes"] + [manifest["y_shape"]]
            if got != want:
                raise ValueError(
                    f"artifact {path} expects input shapes {want} "
                    f"(batch={manifest['batch']}), got {got}"
                )
            if "x_dtypes" in manifest:
                # result_type reads the dtype without a device->host copy
                # (np.asarray would transfer and sync every leaf per call)
                got_dt = [str(np.result_type(l)) for l in leaves] + [
                    str(np.result_type(ys0))
                ]
                want_dt = manifest["x_dtypes"] + [manifest["y_dtype"]]
                if got_dt != want_dt:
                    raise ValueError(
                        f"artifact {path} expects input dtypes {want_dt}, "
                        f"got {got_dt}"
                    )
        return exp.call(xs0, ys0)

    return run, manifest
