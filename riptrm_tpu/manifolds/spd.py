"""Symmetric positive definite matrices with the affine-invariant metric.

Parity target: ``pymanopt.manifolds.SymmetricPositiveDefinite`` as consumed
by ``/root/reference/src/StableIdentification/coordinator.py:39-40``
(second-order retraction P + V + V P^{-1} V / 2, metric
tr(P^{-1} U P^{-1} V), log-eigenvalue distance).

Design: the metric-orthonormal tangent basis is L S_k L^T with
L = chol(P) and {S_k} the Frobenius-orthonormal symmetric basis — one
batched congruence (two matmuls over the stacked basis) instead of
Gram-Schmidt.
"""

from __future__ import annotations

import dataclasses
import math

import jax
import jax.numpy as jnp
from jax.scipy.linalg import cho_solve, solve_triangular

from riptrm_tpu.manifolds.base import Manifold, _sym_basis, sym


@dataclasses.dataclass(frozen=True)
class SymmetricPositiveDefinite(Manifold):
    d: int

    @property
    def dim(self) -> int:
        return self.d * (self.d + 1) // 2

    @property
    def typical_dist(self) -> float:
        return math.sqrt(self.dim)

    def inner(self, x, u, v):
        l = jnp.linalg.cholesky(x)
        iu = cho_solve((l, True), u)
        iv = cho_solve((l, True), v)
        return jnp.sum(iu * iv.T)

    def norm(self, x, u):
        l = jnp.linalg.cholesky(x)
        a = solve_triangular(l, u, lower=True)
        a = solve_triangular(l, a.T, lower=True)  # L^{-1} U L^{-T}
        return jnp.linalg.norm(a)

    def proj(self, x, v):
        return sym(v)

    def retract(self, x, v):
        # Second-order retraction (matches pymanopt).
        l = jnp.linalg.cholesky(x)
        xinv_v = cho_solve((l, True), v)
        return sym(x + v + 0.5 * v @ xinv_v)

    def dist(self, x, y):
        l = jnp.linalg.cholesky(x)
        a = solve_triangular(l, y, lower=True)
        a = solve_triangular(l, a.T, lower=True)  # L^{-1} Y L^{-T}, SPD
        w = jnp.linalg.eigvalsh(sym(a))
        return jnp.linalg.norm(jnp.log(jnp.maximum(w, jnp.finfo(w.dtype).tiny)))

    def egrad2rgrad(self, x, egrad):
        return x @ sym(egrad) @ x

    def ehess2rhess(self, x, egrad, ehess, v):
        # pymanopt: P sym(ehess) P + sym(V sym(egrad) P)
        return x @ sym(ehess) @ x + sym(v @ sym(egrad) @ x)

    def random_point(self, key):
        # Random orthogonal conjugation of eigenvalues in [1, 2]
        # (same distribution family as pymanopt's random_point).
        k1, k2 = jax.random.split(key)
        q, _ = jnp.linalg.qr(jax.random.normal(k1, (self.d, self.d)))
        ev = 1.0 + jax.random.uniform(k2, (self.d,))
        return sym((q * ev) @ q.T)

    def random_tangent(self, key, x):
        c = jax.random.normal(key, (self.dim,), dtype=jnp.asarray(x).dtype)
        c = c / jnp.linalg.norm(c)
        return self.from_coords(x, self.basis(x), c)

    def basis(self, x):
        x = jnp.asarray(x)
        l = jnp.linalg.cholesky(x)
        s = _sym_basis(self.d, dtype=x.dtype)  # [dim, d, d]
        return jnp.einsum("ab,kbc,dc->kad", l, s, l)

    def to_coords(self, x, basis, u):
        """Closed form: with basis_k = L S_k L^T (S_k Frobenius-orthonormal
        symmetric, L = chol(x)), the affine-invariant coordinates are
        c_k = tr(x^{-1} (L S_k L^T) x^{-1} u) = <S_k, L^{-1} u L^{-T}>_F —
        TWO triangular solves total instead of the generic path's ``dim``
        vmapped metric inners (each a pair of cho_solves; the vmapped
        batched triangular solve is column-sequential and dominated the
        Jacobi-preconditioned CR iteration)."""
        x = jnp.asarray(x)
        l = jnp.linalg.cholesky(x)
        a = solve_triangular(l, u, lower=True)
        a = solve_triangular(l, a.T, lower=True)  # L^{-1} u L^{-T}
        s = _sym_basis(self.d, dtype=x.dtype)
        return jnp.tensordot(
            s.reshape(s.shape[0], -1), a.reshape(-1), axes=1
        )
