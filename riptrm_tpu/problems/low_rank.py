"""Nonnegative low-rank matrix approximation on the fixed-rank manifold.

    min_{X in M_k}  0.5 * ||X - A||_F^2   s.t.  X_ij >= lb  elementwise

with M_k the manifold of m x n matrices of rank k (factored (U, S, V)
representation, Vandereycken geometry).  This is the fixed-rank problem
family anticipated by the reference's own TODO
(``/root/reference/src/solver/utils.py:205-209`` "need to add ...
FixedRankEmbedded"); there is no reference implementation to mirror, so the
problem follows the same coordinator shape as the shipped families
(cost + stacked inequality constraints + manifold-violation metric).

Cost and constraints are *ambient* functions of the embedded matrix
X = (U * S) @ V', wired through :class:`riptrm_tpu.problems.embedded.EmbeddedProblem`
so every solver-facing derivative chains through the embedding.  Use the
matrix-free solver paths: RIPTRM(tCG), RIPM(KrylovIterMethod), RALM.
"""

from __future__ import annotations

import jax
import jax.numpy as jnp
import numpy as np

from riptrm_tpu.manifolds.fixed_rank import FixedRankEmbedded
from riptrm_tpu.problems.embedded import EmbeddedProblem, ambient_problem

from riptrm_tpu.utils.devices import local_cpu


def make_problem(A, x0, y0=None, lb: float = 0.0, dtype=None) -> EmbeddedProblem:
    """``A``: target matrix [m, n]; ``x0``: (U [m,k], S [k], V [n,k]) triple;
    feasibility is ``X >= lb`` elementwise (m*n stacked constraints)."""
    A = jnp.asarray(A, dtype=dtype)
    m, n = A.shape
    u0, s0, v0 = (jnp.asarray(a, dtype=dtype) for a in x0)
    k = u0.shape[1]
    man = FixedRankEmbedded(m, n, k)
    dt = s0.dtype
    if y0 is None:
        y0 = jnp.ones((m * n,), dtype=dt)
    else:
        y0 = jnp.asarray(y0, dtype=dt)
    lb = jnp.asarray(lb, dtype=dt)

    def cost(X):
        return 0.5 * jnp.sum((X - A) ** 2)

    def ineq(X):
        return (lb - X).ravel()  # feasible: X >= lb elementwise

    def manvio(x):
        """Factored-representation consistency: orthonormal U/V, S > 0."""
        u, s, v = x
        ku = u.shape[1]
        eye = jnp.eye(ku, dtype=s.dtype)
        return (
            jnp.linalg.norm(u.T @ u - eye)
            + jnp.linalg.norm(v.T @ v - eye)
            + jnp.linalg.norm(jnp.minimum(s, 0.0))
        )

    return ambient_problem(
        man,
        cost,
        ineq=ineq,
        x0=(u0, s0, v0),
        y0=y0,
        z0=jnp.zeros((0,), dtype=dt),
        num_ineq=m * n,
        num_eq=0,
        manvio=manvio,
    )


def load_problem(dataset_path: str, initialpoint: str = "a", lb: float = 0.0, dtype=None):
    """Load a generated instance from the CSV dataset contract
    (``dataset/LowRank/<instance>/``): dim = [m, n, k], target A, factored
    initial point (initU/initS/initV per point name), dual init."""
    from riptrm_tpu.utils.io import loadtxt

    dims = np.atleast_1d(loadtxt(f"{dataset_path}/dim.csv")).astype(int).ravel()
    m, n, k = int(dims[0]), int(dims[1]), int(dims[2])
    A = loadtxt(f"{dataset_path}/A.csv").reshape(m, n)
    u0 = loadtxt(f"{dataset_path}/initU_{initialpoint}.csv").reshape(m, k)
    s0 = np.atleast_1d(loadtxt(f"{dataset_path}/initS_{initialpoint}.csv")).reshape(k)
    v0 = loadtxt(f"{dataset_path}/initV_{initialpoint}.csv").reshape(n, k)
    y0 = np.atleast_1d(loadtxt(f"{dataset_path}/initineqLagmult.csv")).reshape(m * n)
    return make_problem(A, (u0, s0, v0), y0, lb=lb, dtype=dtype)


def generate_instance(key, m: int, n: int, rank: int, noise: float = 0.01):
    """Nonnegative rank-``rank`` target A = W @ H' (entrywise |N(0,1)|
    factors) plus elementwise noise — an NMF-style recovery target.  Runs on
    the CPU backend, so a seed gives bit-identical instances on every
    machine."""
    cpu = local_cpu()
    key = jax.device_put(key, cpu)
    with jax.default_device(cpu):
        k1, k2, k3 = jax.random.split(key, 3)
        w = jnp.abs(jax.random.normal(k1, (m, rank)))
        h = jnp.abs(jax.random.normal(k2, (n, rank)))
        a = w @ h.T / np.sqrt(rank) + noise * jax.random.normal(k3, (m, n))
        return {"dim": np.array([[m, n, rank]]), "A": np.asarray(a)}


def generate_initialpoint(key, m: int, n: int, k: int, lb: float = 0.0, margin: float = 0.1):
    """Strictly feasible rank-k initial point: a dominant entrywise-positive
    rank-1 component plus a small rank-(k-1) perturbation, scaled down until
    every entry clears ``lb`` by ``margin`` (generator-side retry in the
    spirit of the reference's feasible-start searches,
    ``StableIdentification/generator.py:137-223``)."""
    cpu = local_cpu()
    key = jax.device_put(key, cpu)
    with jax.default_device(cpu):
        k1, k2, k3 = jax.random.split(key, 3)
        w = jnp.abs(jax.random.normal(k1, (m,))) + 0.5
        h = jnp.abs(jax.random.normal(k2, (n,))) + 0.5
        base = jnp.outer(w, h)
        pert = jnp.zeros((m, n))
        if k > 1:
            ww = jax.random.normal(k3, (m, k - 1))
            hh = jax.random.normal(jax.random.fold_in(k3, 1), (n, k - 1))
            pert = ww @ hh.T
        if float(jnp.min(base)) <= lb + margin:
            # halving eps only drives x toward `base`; if base itself
            # cannot clear the bound the loop would never terminate —
            # lift the rank-1 component instead of hanging
            base = base + (lb + margin - float(jnp.min(base))) + 0.1
        eps = 0.1
        x = base + eps * pert
        for _ in range(200):
            if float(jnp.min(x)) > lb + margin:
                break
            eps *= 0.5
            x = base + eps * pert
        else:
            raise ValueError(
                f"no strictly feasible rank-{k} start found (lb={lb}, "
                f"margin={margin})"
            )
        u, s, vt = jnp.linalg.svd(x, full_matrices=False)
        return (
            np.asarray(u[:, :k]),
            np.asarray(s[:k]),
            np.asarray(vt[:k, :].T),
        )
