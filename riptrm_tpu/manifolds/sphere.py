"""Unit sphere S^{n-1} embedded in R^n.

Parity target: ``pymanopt.manifolds.sphere.Sphere`` as consumed by
``/root/reference/src/NonnegPCA/coordinator.py:41`` and the solvers
(SURVEY.md §2.2).

Design: the orthonormal tangent basis is the first n-1 columns of the
Householder reflector mapping e_n to ±x — closed form, one outer product,
instead of the reference's random-vector Gram-Schmidt
(``/root/reference/src/solver/utils.py:388-397``).
"""

from __future__ import annotations

import dataclasses
import math

import jax
import jax.numpy as jnp

from riptrm_tpu.manifolds.base import Manifold


@dataclasses.dataclass(frozen=True)
class Sphere(Manifold):
    n: int  # ambient dimension; manifold is S^{n-1}

    @property
    def dim(self) -> int:
        return self.n - 1

    @property
    def typical_dist(self) -> float:
        return math.pi

    def inner(self, x, u, v):
        return jnp.vdot(u, v)

    def proj(self, x, v):
        return v - jnp.vdot(x, v) * x

    def retract(self, x, v):
        y = x + v
        return y / jnp.linalg.norm(y)

    def dist(self, x, y):
        # Numerically robust arccos form (matches pymanopt's formulation).
        inner = jnp.clip(jnp.vdot(x, y), -1.0, 1.0)
        return jnp.arccos(inner)

    def egrad2rgrad(self, x, egrad):
        return self.proj(x, egrad)

    def ehess2rhess(self, x, egrad, ehess, v):
        return self.proj(x, ehess) - jnp.vdot(x, egrad) * v

    def random_point(self, key):
        v = jax.random.normal(key, (self.n,))
        return v / jnp.linalg.norm(v)

    def random_tangent(self, key, x):
        v = self.proj(x, jax.random.normal(key, (self.n,), dtype=jnp.asarray(x).dtype))
        return v / self.norm(x, v)

    def basis(self, x):
        x = jnp.asarray(x)
        n = self.n
        s = jnp.where(x[n - 1] >= 0, 1.0, -1.0).astype(x.dtype)
        e_n = jnp.zeros(n, dtype=x.dtype).at[n - 1].set(1.0)
        w = x + s * e_n
        h = jnp.eye(n, dtype=x.dtype) - (2.0 / jnp.vdot(w, w)) * jnp.outer(w, w)
        # Columns 0..n-2 of the (symmetric, orthogonal) reflector are an
        # orthonormal basis of x^perp; column n-1 equals -s*x.
        return h[:, : n - 1].T  # stacked [dim, n]
