"""Grassmann manifold Gr(n, p): p-dimensional subspaces of R^n.

Points are represented by n x p orthonormal matrices; tangent vectors are
n x p matrices in the horizontal space (X^T V = 0).

Parity target: ``pymanopt.manifolds.Grassmann`` as consumed by
``/root/reference/src/Rosenbrock/coordinator.py:36`` (polar retraction,
principal-angle distance, projection-based gradient/Hessian conversion).

Design: tangent basis from one complete QR (the orthonormal completion
X_perp), so basis vectors are X_perp[:, k] e_j^T — closed form, batched.
"""

from __future__ import annotations

import dataclasses
import math

import jax
import jax.numpy as jnp

from riptrm_tpu.manifolds.base import Manifold, orthonormal_completion


@dataclasses.dataclass(frozen=True)
class Grassmann(Manifold):
    n: int
    p: int

    @property
    def dim(self) -> int:
        return self.p * (self.n - self.p)

    @property
    def typical_dist(self) -> float:
        return math.sqrt(self.p)

    def inner(self, x, u, v):
        return jnp.vdot(u, v)

    def proj(self, x, v):
        return v - x @ (x.T @ v)

    def retract(self, x, v):
        # Polar retraction via SVD (matches pymanopt Grassmann.retraction).
        u, _, vt = jnp.linalg.svd(x + v, full_matrices=False)
        return u @ vt

    def dist(self, x, y):
        s = jnp.linalg.svd(x.T @ y, compute_uv=False)
        s = jnp.clip(s, -1.0, 1.0)
        return jnp.linalg.norm(jnp.arccos(s))

    def egrad2rgrad(self, x, egrad):
        return self.proj(x, egrad)

    def ehess2rhess(self, x, egrad, ehess, v):
        return self.proj(x, ehess) - v @ (x.T @ egrad)

    def random_point(self, key):
        a = jax.random.normal(key, (self.n, self.p))
        q, _ = jnp.linalg.qr(a)
        return q

    def random_tangent(self, key, x):
        v = self.proj(x, jax.random.normal(key, (self.n, self.p), dtype=jnp.asarray(x).dtype))
        return v / self.norm(x, v)

    def _perp(self, x):
        return orthonormal_completion(x)

    def basis(self, x):
        x = jnp.asarray(x)
        xp = self._perp(x)  # [n, n-p]
        eye = jnp.eye(self.p, dtype=x.dtype)
        # basis[(k, j)] = outer(xp[:, k], e_j): stacked [(n-p)*p, n, p]
        b = jnp.einsum("ik,jl->kjil", xp, eye)
        return b.reshape(((self.n - self.p) * self.p, self.n, self.p))
