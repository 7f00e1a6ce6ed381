"""Nonnegative PCA: max x^T Z x on the sphere S^{n-1} with x >= 0.

Parity targets: ``/root/reference/src/NonnegPCA/coordinator.py`` (cost
:52-55, constraints :66-77, manifold :41), ``generator.py`` (spiked Z :9-31,
initial points :34-54, dual init :57-65) and ``simulator.py`` (sphere
manifold-violation ||x|| - 1, :12-14).

Design: the n per-element constraints are one stacked function
g(x) = -x, so all constraint derivatives are trivial index-free tensor ops.
"""

from __future__ import annotations

import jax
import jax.numpy as jnp
import numpy as np

from riptrm_tpu.manifolds import Sphere
from riptrm_tpu.problems.problem import Problem
from riptrm_tpu.utils.io import loadtxt

from riptrm_tpu.utils.devices import local_cpu


def make_problem(Z, x0, y0=None, dtype=None, matmul_precision=None) -> Problem:
    """``matmul_precision``: None uses the backend default (on a GPU an
    f32 matmul may run in TF32); 'highest' forces full-f32 matmuls —
    needed when f32 batched sweeps must reach tight KKT tolerances
    (PERF.md, precision on the H100)."""
    # TP axis: a caller that device_put Z with a NamedSharding (e.g. the
    # dryrun's P("tp", None) row sharding) gets the sharding RE-PINNED
    # IN-GRAPH below — jax.jit does NOT honor committed shardings of
    # closure-captured constants (it folds them into a single-device
    # program; measured round 5 on the StableIdentification data axis),
    # so without the pin the "sharded" matvec never partitions.
    zs_sharding = None
    sh = getattr(Z, "sharding", None)
    if sh is not None and getattr(sh, "mesh", None) is not None:
        if not sh.is_fully_replicated:
            zs_sharding = sh
    Z = jnp.asarray(Z, dtype=dtype)
    # -x'Zx == -x'(Z+Z')x/2 exactly; symmetrizing once at build time halves
    # the HVP memory traffic (one matvec per Hessian application instead of
    # Z@dx plus Z'@dx through AD) — the hot op of the tCG loop.
    Zs = 0.5 * (Z + Z.T)
    if zs_sharding is not None:
        Zs = jax.device_put(Zs, zs_sharding)
    x0 = jnp.asarray(x0, dtype=dtype)
    n = Z.shape[0]
    man = Sphere(n)
    if y0 is None:
        y0 = jnp.ones((n,), dtype=x0.dtype)
    else:
        y0 = jnp.asarray(y0, dtype=x0.dtype)

    def _zs():
        if zs_sharding is None:
            return Zs
        return jax.lax.with_sharding_constraint(Zs, zs_sharding)

    def cost(x):
        zp = _zs()
        if matmul_precision is not None:
            with jax.default_matmul_precision(matmul_precision):
                return -(x @ (zp @ x))
        return -(x @ (zp @ x))

    def ineq(x):
        return -x  # feasible: x >= 0

    def manvio(x):
        return jnp.linalg.norm(x) - 1.0

    return Problem(
        manifold=man,
        cost=cost,
        ineq=ineq,
        x0=x0,
        y0=y0,
        z0=jnp.zeros((0,), dtype=x0.dtype),
        num_ineq=n,
        num_eq=0,
        manvio=manvio,
        structure={"kind": "sphere_quadratic", "Zs": Zs},
    )


def load_problem(dataset_path: str, initialpoint: str = "a", dtype=None) -> Problem:
    """Load a shipped instance (reference ``coordinator.py:17-99``)."""
    Z = loadtxt(f"{dataset_path}/Z.csv")
    x0 = loadtxt(f"{dataset_path}/initx_{initialpoint}.csv")
    y0 = loadtxt(f"{dataset_path}/initineqLagmult.csv")
    return make_problem(Z, x0, y0, dtype=dtype)


def generate_instance(key, dim: int, snr: float = 0.5, delta: float = 0.7):
    """Spiked-covariance instance (reference ``generator.py:9-31``).

    Returns dict of arrays matching the dataset CSV contract.  Runs on the
    CPU backend, so a seed gives bit-identical instances on every machine
    (matching ``dataset/`` and ``dataset/_cache``).
    """
    cpu = local_cpu()
    # device_put the key too: a device-resident key would pull every eager
    # op back onto the default device despite default_device.
    key = jax.device_put(key, cpu)
    with jax.default_device(cpu):
        return _generate_instance(key, dim, snr, delta)


def _generate_instance(key, dim, snr, delta):
    k1, k2, k3 = jax.random.split(key, 3)
    samplesize = int(np.floor(delta * dim))
    # permutation + mask instead of scatter; random.choice(replace=False)
    # and scatter updates compile pathologically slowly on this backend
    support = jax.random.permutation(k1, dim) < samplesize
    v = support / np.sqrt(samplesize)
    noise = jax.random.normal(k2, (dim, dim)) / np.sqrt(dim)
    diag_noise = jax.random.normal(k3, (dim,)) * 2.0 / np.sqrt(dim)
    eye = jnp.eye(dim)
    noise = noise * (1.0 - eye) + jnp.diag(diag_noise)
    z = jnp.sqrt(snr) * jnp.outer(v, v) + noise
    return {"dim": np.array([[dim]]), "Z": np.asarray(z)}


def generate_initialpoint(key, dim: int, feasible: bool = True):
    """Random unit-norm initial point (reference ``generator.py:34-54``).
    Runs on the CPU backend like every generator here."""
    cpu = local_cpu()
    with jax.default_device(cpu):
        x0 = jax.random.uniform(jax.device_put(key, cpu), (dim,))
        x0 = x0 / jnp.linalg.norm(x0)
        if feasible:
            x0 = jnp.abs(x0)
    return np.asarray(x0)
