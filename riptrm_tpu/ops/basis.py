"""Tangent-space operator materialization via batched transforms.

Replaces the reference's sequential loops
(``selfadj_operator2matrix``/``operator2matrix``/``tangent2vec``,
``/root/reference/src/solver/utils.py:532-580``): a dim x dim representing
matrix is built with ONE ``vmap`` over coordinate directions (dim batched
HVPs) followed by one batched projection — two batched matrix-shaped ops
instead of O(dim^2) sequential inner products.
"""

from __future__ import annotations

import jax
import jax.numpy as jnp


def materialize(manifold, x, basis, op):
    """Dense matrix A with A[i, j] = <basis_i, op(basis_j)>_x.

    ``op`` maps tangent pytrees to tangent pytrees.  The result represents
    ``op`` in metric-orthonormal coordinates (Gram matrix = I).
    """
    dim = manifold.dim
    eye = jnp.eye(dim)

    def column(e):
        return manifold.to_coords(x, basis, op(manifold.from_coords(x, basis, e)))

    return jax.vmap(column)(eye).T  # columns j = op(basis_j) in coords


def materialize_symmetrized(manifold, x, basis, op):
    """As ``materialize`` but symmetrized, for self-adjoint operators whose
    numerical representation may be slightly asymmetric
    (reference ``selfadj_operator2matrix``, ``utils.py:565-573``)."""
    a = materialize(manifold, x, basis, op)
    return 0.5 * (a + a.T)


def materialize_sharded(manifold, x, basis, op, mesh, axis: str = "tp"):
    """``materialize`` with the batched HVP fan-out sharded over a mesh axis.

    For large single instances (SURVEY §2.3 "shard the HVP matvec"): each
    device computes dim/axis_size columns of the representing matrix; the
    result is all-gathered so every device holds the full dim x dim matrix
    for the downstream TRS/eigh.  dim must be divisible by the axis size
    (pad the basis otherwise).
    """
    dim = manifold.dim
    n_shards = mesh.shape[axis]
    assert dim % n_shards == 0, f"dim {dim} not divisible by {axis}={n_shards}"
    eye = jnp.eye(dim)

    def column(e):
        return manifold.to_coords(x, basis, op(manifold.from_coords(x, basis, e)))

    def shard_fn(eye_chunk):
        cols = jax.vmap(column)(eye_chunk)  # [dim/n_shards, dim]
        return jax.lax.all_gather(cols, axis, tiled=True)  # [dim, dim]

    from jax.sharding import PartitionSpec as P

    fn = jax.shard_map(
        shard_fn, mesh=mesh, in_specs=P(axis), out_specs=P(), check_vma=False
    )
    return fn(eye).T


def sphere_householder_congruence(x, a_mat, kappa):
    """Closed-form O(n^2) coordinate materialization on the sphere.

    For an operator ``op(v) = P a_mat v - kappa * v`` on tangent vectors at
    ``x`` in S^{n-1} (P = I - xx'; every Riemannian Hessian on the sphere has
    this form, ``manifolds/sphere.py::ehess2rhess``), the representing matrix
    in the Householder basis of ``Sphere.basis`` is the congruence

        (H a_mat H)[:n-1, :n-1] - kappa I,   H = I - beta w w',

    with w = x + sign(x_n) e_n.  H a_mat H expands to two symmetric rank-1
    updates around ONE a_mat @ w matvec — O(n^2) total, replacing the dim
    batched HVPs of ``materialize`` (O(n^2 dim)); this is the reference's
    ``selfadj_operator2matrix`` (``utils.py:565-573``) made closed-form for
    structured problems (NonnegPCA: a_mat = -2 Zs + diag(y/c)).

    The projector P needs no explicit handling: the basis rows b_i satisfy
    b_i' x = 0, so b_i' P a_mat P b_j = b_i' a_mat b_j exactly.
    """
    n = x.shape[0]
    dt = a_mat.dtype
    s = jnp.where(x[n - 1] >= 0, 1.0, -1.0).astype(dt)
    w = x.at[n - 1].add(s)
    beta = 2.0 / (w @ w)
    u = a_mat @ w
    v = -beta * u + (0.5 * beta * beta * (w @ u)) * w
    m = a_mat + jnp.outer(w, v) + jnp.outer(v, w)
    h = m[: n - 1, : n - 1] - kappa * jnp.eye(n - 1, dtype=dt)
    return 0.5 * (h + h.T)


def sphere_householder_coords(x, v_amb):
    """Coordinates of the tangent projection of ambient ``v_amb`` in the
    ``Sphere.basis`` Householder basis, without materializing the basis:
    B v = (H v)[:n-1] (and B P v = B v since B x = 0).  O(n)."""
    n = x.shape[0]
    s = jnp.where(x[n - 1] >= 0, 1.0, -1.0).astype(v_amb.dtype)
    w = x.at[n - 1].add(s)
    beta = 2.0 / (w @ w)
    return (v_amb - beta * (w @ v_amb) * w)[: n - 1]


def covector(manifold, x, basis, v):
    """Coordinates of a tangent vector v (reference ``tangent2vec``,
    ``utils.py:575-580``)."""
    return manifold.to_coords(x, basis, v)


def constraint_grad_rows(manifold, x, basis, fn, m, dtype=None):
    """Rows of Riemannian constraint gradients in basis coordinates.

    G[i, :] = coords of rgrad fn_i at x, for a stacked constraint function
    ``fn: M -> R^m``, via ONE vjp (linearized once, pulled back along the m
    coordinate covectors with a single vmap).  Shared by RSQO's linearized
    constraint matrices, RIPM's equality-gradient matrix, and the
    Rosenbrock second-order-residual callback (reference: per-constraint
    gradient loops, ``utils.py:93-203`` / ``RSQO.py:160-191``).
    """
    _, pullback = jax.vjp(fn, x)

    def row(e):
        (eg,) = pullback(e)
        return manifold.to_coords(x, basis, manifold.egrad2rgrad(x, eg))

    eye = jnp.eye(m) if dtype is None else jnp.eye(m, dtype=dtype)
    return jax.vmap(row)(eye)
