"""Bounded-coordinate PCA on the Stiefel manifold (Brockett form).

    max tr(X' Z X D)  on  St(n, p)   s.t.  |X_ij| <= bound  elementwise

with D = diag(d_1 > ... > d_p > 0) the Brockett weights.  The p = 1,
one-sided case is the reference's NonnegPCA
(``/root/reference/src/NonnegPCA/coordinator.py``); for p >= 2 a
*nonnegativity* constraint is degenerate for interior-point methods
(orthonormal nonnegative columns must have disjoint supports, so the
strictly feasible set is empty), hence the two-sided coordinate bound —
the classic "delocalized" PCA variant with a nonempty interior and
genuinely active constraints at optima whenever the leading eigenvectors
are localized.  Stiefel is a north-star primitive (BASELINE.json); there
is no reference counterpart to mirror.

The DISTINCT weights matter: the unweighted trace tr(X'ZX) is invariant
under X -> XQ for any orthogonal Q, so its barrier subproblems have a
p(p-1)/2-dimensional near-null gauge orbit (measured: an eigenvalue
cluster at ~1e-4 in Hw at St(128, 8)) along which a trust-region walk
cycles without ever centering the duals — in f32 the inner loop then
stalls at the first barrier parameter.  The Brockett weights break the
gauge, giving isolated minimizers (the top-p eigenvectors, ordered) and an
f32-viable problem at production sizes.

St(n, p) has a closed-form tangent basis (``manifolds/stiefel.py``), so
ALL solver paths run: RIPTRM tCG and Exact_RepMat (incl. dense
second-order certificates), RIPM both modes, RSQO, RALM.
"""

from __future__ import annotations

import math

import jax
import jax.numpy as jnp
import numpy as np

from riptrm_tpu.manifolds.stiefel import Stiefel
from riptrm_tpu.problems.problem import Problem

from riptrm_tpu.utils.devices import local_cpu


def make_problem(Z, x0, y0=None, bound: float = 0.8, dtype=None, weights=None) -> Problem:
    Z = jnp.asarray(Z, dtype=dtype)
    Zs = 0.5 * (Z + Z.T)
    x0 = jnp.asarray(x0, dtype=dtype)
    n, p = x0.shape
    man = Stiefel(n, p)
    dt = x0.dtype
    m = 2 * n * p
    if y0 is None:
        y0 = jnp.ones((m,), dtype=dt)
    else:
        y0 = jnp.asarray(y0, dtype=dt)
    b = jnp.asarray(bound, dtype=dt)
    if weights is None:
        # Brockett weights d_k = 1 + (p - k)/p in (1, 2]: distinct (gap 1/p
        # breaks the gauge orbit) and O(1)-bounded away from zero, so no
        # column's cost contribution vanishes relative to the others
        d = 1.0 + jnp.arange(p - 1, -1, -1, dtype=dt) / p
    else:
        d = jnp.asarray(weights, dtype=dt)

    def cost(x):
        return -jnp.sum((x * (Zs @ x)) * d)

    def ineq(x):
        # feasible: x <= b and -x <= b, stacked [2 n p]
        return jnp.concatenate([(x - b).ravel(), (-x - b).ravel()])

    def manvio(x):
        return jnp.linalg.norm(x.T @ x - jnp.eye(p, dtype=x.dtype))

    return Problem(
        manifold=man,
        cost=cost,
        ineq=ineq,
        x0=x0,
        y0=y0,
        z0=jnp.zeros((0,), dtype=dt),
        num_ineq=m,
        num_eq=0,
        manvio=manvio,
    )


def load_problem(dataset_path: str, initialpoint: str = "a", bound: float = 0.8, dtype=None):
    from riptrm_tpu.utils.io import loadtxt

    dims = np.atleast_1d(loadtxt(f"{dataset_path}/dim.csv")).astype(int).ravel()
    n, p = int(dims[0]), int(dims[1])
    Z = loadtxt(f"{dataset_path}/Z.csv").reshape(n, n)
    x0 = loadtxt(f"{dataset_path}/initx_{initialpoint}.csv").reshape(n, p)
    y0 = np.atleast_1d(loadtxt(f"{dataset_path}/initineqLagmult.csv")).reshape(2 * n * p)
    return make_problem(Z, x0, y0, bound=bound, dtype=dtype)


def generate_instance(key, dim: int, snr: float = 0.5, delta: float = 0.7):
    """Spiked-covariance Z, same construction as NonnegPCA
    (``/root/reference/src/NonnegPCA/generator.py:9-31``)."""
    from riptrm_tpu.problems.nonneg_pca import generate_instance as gen

    return gen(key, dim, snr, delta)


def generate_initialpoint(key, n: int, p: int, bound: float = 0.8, margin: float = 0.05, max_draws: int = 20_000):
    """Strictly feasible orthonormal start: QR of a Gaussian matrix,
    redrawn until every |entry| clears the bound by ``margin`` (entries of
    a random orthonormal frame concentrate at O(sqrt(log(np)/n)), so for
    reasonable (n, p, bound) the first draw almost always passes)."""
    if bound - margin <= 1.0 / math.sqrt(n):
        # every orthonormal column has max|entry| >= 1/sqrt(n): the
        # acceptance condition would be unsatisfiable and the redraw loop
        # would never terminate
        raise ValueError(
            f"bound - margin = {bound - margin:.3g} <= 1/sqrt(n) = "
            f"{1.0 / math.sqrt(n):.3g}: no orthonormal frame can satisfy it"
        )
    cpu = local_cpu()
    key = jax.device_put(key, cpu)
    with jax.default_device(cpu):
        for _ in range(max_draws):
            key, sub = jax.random.split(key)
            q, _ = jnp.linalg.qr(jax.random.normal(sub, (n, p)))
            if float(jnp.max(jnp.abs(q))) <= bound - margin:
                return np.asarray(q)
    raise ValueError(
        f"no feasible start found in {max_draws} draws (n={n}, p={p}, "
        f"bound={bound}, margin={margin}): the bound is too tight for "
        "random orthonormal frames"
    )
