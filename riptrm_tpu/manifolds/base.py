"""Manifold protocol: pure, jittable functions over pytrees.

Design notes:

* Points and tangent vectors are pytrees of ``jnp`` arrays; every operation is
  a pure function usable under ``jit``/``vmap``/``shard_map``.
* Each manifold provides a *deterministic, closed-form* orthonormal tangent
  basis ``basis(x)`` (stacked along a leading axis of length ``dim``).  The
  reference instead draws ``dim`` random tangent vectors and Gram-Schmidts
  them sequentially (``/root/reference/src/solver/utils.py:370-397``), which is
  O(dim^2) sequential metric inner products — hostile to a vector machine.
  Closed-form bases turn all operator<->matrix conversions into batched
  ``vmap`` calls that XLA maps onto batched matrix products.
* ``to_coords``/``from_coords`` move between tangent vectors and coordinate
  vectors in R^dim under the metric-orthonormal basis.  All dense solver
  algebra (TRS, QP, eigendecompositions) happens in coordinates, where the
  Gram matrix is exactly the identity.

Reference API parity: mirrors the Pymanopt surface consumed by the reference
solvers (``inner_product``, ``norm``, ``dist``, ``retraction``,
``zero_vector``, ``random_point``, ``random_tangent_vector``,
``to_tangent_space`` (= ``proj``), ``euclidean_to_riemannian_gradient``,
``euclidean_to_riemannian_hessian``, ``dim``, ``typical_dist`` — see
SURVEY.md §2.2).
"""

from __future__ import annotations

import dataclasses
from typing import Any

import jax
import jax.numpy as jnp

Array = Any
PyTree = Any


@dataclasses.dataclass(frozen=True)
class Manifold:
    """Abstract base.  Subclasses are frozen dataclasses of *static* shape
    parameters only, so they hash and can be closed over by jitted functions.
    """

    # ---- static properties -------------------------------------------------
    @property
    def dim(self) -> int:  # intrinsic dimension
        raise NotImplementedError

    @property
    def typical_dist(self) -> float:
        raise NotImplementedError

    # ---- core ops ----------------------------------------------------------
    def inner(self, x: PyTree, u: PyTree, v: PyTree) -> Array:
        raise NotImplementedError

    def norm(self, x: PyTree, u: PyTree) -> Array:
        return jnp.sqrt(jnp.maximum(self.inner(x, u, u), 0.0))

    def proj(self, x: PyTree, v: PyTree) -> PyTree:
        """Orthogonal projection of an ambient vector onto T_x M."""
        raise NotImplementedError

    def retract(self, x: PyTree, v: PyTree) -> PyTree:
        raise NotImplementedError

    def dist(self, x: PyTree, y: PyTree) -> Array:
        raise NotImplementedError

    def zero_vector(self, x: PyTree) -> PyTree:
        return jax.tree.map(jnp.zeros_like, x)

    # ---- Euclidean -> Riemannian conversions -------------------------------
    def egrad2rgrad(self, x: PyTree, egrad: PyTree) -> PyTree:
        return self.proj(x, egrad)

    def ehess2rhess(self, x: PyTree, egrad: PyTree, ehess: PyTree, v: PyTree) -> PyTree:
        raise NotImplementedError

    def proj_tangent(self, x: PyTree, t: PyTree) -> PyTree:
        """Re-project a (numerically drifted) *tangent-typed* value back onto
        T_x M.  Identical to ``proj`` when tangents share the ambient
        representation (every manifold here except FixedRankEmbedded, whose
        structured tangents need their own re-orthogonalization)."""
        return self.proj(x, t)

    # ---- vector transport --------------------------------------------------
    def transport(self, x, y, v):
        """Transport tangent v from T_x to T_y (default: projection
        transport — the standard choice for embedded manifolds)."""
        return self.proj(y, v)

    # ---- randomness (explicit keys; reference uses global numpy RNG) -------
    def random_point(self, key: Array) -> PyTree:
        raise NotImplementedError

    def random_tangent(self, key: Array, x: PyTree) -> PyTree:
        raise NotImplementedError

    # ---- tangent basis / coordinates ---------------------------------------
    def basis(self, x: PyTree) -> PyTree:
        """Stacked orthonormal (w.r.t. the metric at x) tangent basis.

        Returns a pytree whose leaves have a leading axis of length ``dim``;
        slice ``k`` is the k-th basis tangent vector.
        """
        raise NotImplementedError

    def from_coords(self, x: PyTree, basis: PyTree, c: Array) -> PyTree:
        """Linear combination sum_k c_k * basis_k  (batched tensordot)."""
        return jax.tree.map(
            lambda b: jnp.tensordot(c, b.reshape(b.shape[0], -1), axes=1).reshape(b.shape[1:]),
            basis,
        )

    def to_coords(self, x: PyTree, basis: PyTree, u: PyTree) -> Array:
        """Metric inner products of u against every basis vector."""
        return jax.vmap(lambda b: self.inner(x, b, u))(basis)

    # ---- defaults ----------------------------------------------------------
    def flat_dim(self, x: PyTree) -> int:
        """Total number of ambient scalars in a point/tangent representation."""
        return sum(int(jnp.size(leaf)) for leaf in jax.tree.leaves(x))


def sym(a: Array) -> Array:
    return 0.5 * (a + a.swapaxes(-1, -2))


def skew(a: Array) -> Array:
    return 0.5 * (a - a.swapaxes(-1, -2))


def _sym_basis(d: int, dtype=jnp.float64) -> Array:
    """Orthonormal (Frobenius) basis of d x d symmetric matrices.

    Stacked [d(d+1)/2, d, d]: E_ii then (E_ij + E_ji)/sqrt(2) for i<j.
    Built with one scatter; deterministic ordering (diagonal first, then
    row-major upper triangle).
    """
    import numpy as np

    n = d * (d + 1) // 2
    out = np.zeros((n, d, d))
    k = 0
    for i in range(d):
        out[k, i, i] = 1.0
        k += 1
    inv_sqrt2 = 1.0 / np.sqrt(2.0)
    for i in range(d):
        for j in range(i + 1, d):
            out[k, i, j] = inv_sqrt2
            out[k, j, i] = inv_sqrt2
            k += 1
    return jnp.asarray(out, dtype=dtype)


def _skew_basis(d: int, dtype=jnp.float64) -> Array:
    """Orthonormal (Frobenius) basis of d x d skew-symmetric matrices."""
    import numpy as np

    n = d * (d - 1) // 2
    out = np.zeros((n, d, d))
    k = 0
    inv_sqrt2 = 1.0 / np.sqrt(2.0)
    for i in range(d):
        for j in range(i + 1, d):
            out[k, i, j] = inv_sqrt2
            out[k, j, i] = -inv_sqrt2
            k += 1
    return jnp.asarray(out, dtype=dtype)


def orthonormal_completion(x):
    """X_perp in R^{n x (n-p)}: orthonormal completion of the orthonormal
    frame x via complete QR (shared by Grassmann/Stiefel bases)."""
    q, _ = jnp.linalg.qr(x, mode="complete")
    return q[:, x.shape[1]:]
