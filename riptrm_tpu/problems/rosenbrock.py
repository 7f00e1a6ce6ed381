"""Chained Rosenbrock minimization on the Grassmann manifold.

Parity targets: ``/root/reference/src/Rosenbrock/coordinator.py`` (cost
:44-52, constraints :58-71, x0 :78-84) and ``simulator.py`` (second-order
residual callback :60-105, rank-based manifold violation :107-114).

Design notes:
* The chained Rosenbrock sum is one shifted-difference reduction, not a
  Python loop over nk scalars.
* The second-order-residual callback (min eigenvalue of Hess L restricted
  to the null space of active constraint gradients) is fully jittable: the
  active set is a mask, the null-space restriction is a projector built
  from one SVD, and the variable null-space dimension is handled by
  shifting the complement spectrum out of the way — no ragged shapes.
"""

from __future__ import annotations

import jax
import jax.numpy as jnp

from riptrm_tpu.manifolds import Grassmann
from riptrm_tpu.ops.basis import constraint_grad_rows, materialize_symmetrized
from riptrm_tpu.problems.problem import Problem


def second_order_residual(problem, x, y, z, *, active_tol=1e-5, linindtol=1e-12):
    """(min eigval, condition number) of Hess_x L restricted to the null
    space of the active constraint gradients (``simulator.py:60-105``)."""
    man = problem.manifold
    dim = man.dim
    m = problem.num_ineq
    basis = man.basis(x)

    g = problem.ineq_val(x)
    active = jnp.abs(g) < active_tol  # [m]

    # Coordinate rows of the Riemannian constraint gradients (one vmapped vjp)
    g_rows = constraint_grad_rows(man, x, basis, problem.ineq, m, dtype=g.dtype)
    ga = jnp.where(active[:, None], g_rows, 0.0)

    # Projector onto span(active gradients) via SVD with rank tolerance
    _, s, vt = jnp.linalg.svd(ga, full_matrices=False)
    rank_mask = s > linindtol
    r = jnp.sum(rank_mask)
    p_span = (vt.T * rank_mask.astype(g.dtype)) @ vt  # sum of v_i v_i^T over rank
    p_null = jnp.eye(dim, dtype=g.dtype) - p_span

    h_mat = materialize_symmetrized(
        man, x, basis, lambda v: problem.lag_rhess(x, y, v, z)
    )
    big = (1.0 + jnp.linalg.norm(h_mat)) * 1e3
    shifted = p_null @ h_mat @ p_null + big * p_span
    w = jnp.linalg.eigvalsh(shifted)  # ascending; first dim-r are null-space

    nulldim = dim - r
    mineig = jnp.where(nulldim > 0, w[0], 0.0)
    max_null = jnp.where(
        nulldim > 0,
        w[jnp.clip(nulldim - 1, 0, dim - 1)],
        jnp.nan,
    )
    condnum = jnp.where(nulldim > 0, max_null / mineig, jnp.nan)
    return mineig, condnum


def make_problem(n: int, k: int, alpha: float = 1e7, dtype=None) -> Problem:
    man = Grassmann(n, k)
    m = n * k
    dt = dtype or jnp.zeros(0).dtype

    def cost(x):
        v = x.reshape(-1)
        return jnp.sum(alpha * (v[1:] - v[:-1]) ** 2 + (1.0 - v[:-1]) ** 2)

    def ineq(x):
        return -x.reshape(-1) - 0.01  # feasible: x_i >= -0.01

    def manvio(x):
        # rank check (simulator.py:107-114)
        s = jnp.linalg.svd(x, compute_uv=False)
        rank = jnp.sum(s > 1e-10)
        return jnp.where(rank == k, 0.0, jnp.inf)

    x0 = jnp.abs(jnp.eye(n, dtype=dt)[:, :k])
    y0 = jnp.ones((m,), dtype=x0.dtype)

    def callback(prob, x, y, z, ev):
        mineig, condnum = second_order_residual(prob, x, y, z)
        ev["second_order_residual"] = mineig
        ev["condition_number"] = condnum
        return ev

    return Problem(
        manifold=man,
        cost=cost,
        ineq=ineq,
        x0=x0,
        y0=y0,
        z0=jnp.zeros((0,), dtype=x0.dtype),
        num_ineq=m,
        num_eq=0,
        manvio=manvio,
        callback=callback,
    )
