"""Constrained Riemannian problem with *stacked* constraints.

Replaces the reference's ``NonlinearProblem``
(``/root/reference/src/solver/utils.py:33-203``), which keeps one autograd
closure per constraint plus lazily-cached per-constraint gradient/Hessian
operators, and whose solvers loop over the m constraints in Python
(``RIPTRM.py:486-522``).  Here constraints are a single jittable function
``ineq: M -> R^m`` and all solver-facing operators are single JAX transforms:

* weighted constraint-gradient combinations via one ``vjp``
* stacked directional derivatives via one ``jvp``
* Lagrangian Hessian-vector products via ``jvp``-of-``grad``

so the per-iteration work is a handful of fused XLA kernels regardless of m.

Sign conventions (match the reference):
  feasible      <=>  ineq(x) <= 0 elementwise (and eq(x) = 0)
  slack         c(x) = -ineq(x) > 0 at strictly feasible points
  Lagrangian    L(x, y, z) = f(x) + y . ineq(x) + z . eq(x),  y >= 0
"""

from __future__ import annotations

import dataclasses
from typing import Any, Callable, Optional

import jax
import jax.numpy as jnp

from riptrm_tpu.manifolds.base import Manifold

PyTree = Any


@dataclasses.dataclass(frozen=True)
class Problem:
    manifold: Manifold
    cost: Callable[[PyTree], Any]
    ineq: Optional[Callable[[PyTree], Any]] = None  # g: M -> R^m, feasible g<=0
    eq: Optional[Callable[[PyTree], Any]] = None  # h: M -> R^l
    x0: PyTree = None
    y0: Any = None  # initial inequality multipliers, [m]
    z0: Any = None  # initial equality multipliers, [l]
    num_ineq: int = 0
    num_eq: int = 0
    # Extra residual term for manifold-constraint violation, (x) -> scalar
    manvio: Callable[[PyTree], Any] = None
    # Extra per-iteration metrics, (problem, x, y, z, eval_dict) -> eval_dict
    callback: Callable = None
    # Optional structure metadata enabling closed-form fast paths, e.g.
    # {"kind": "sphere_quadratic", "Zs": <sym matrix>} lets RIPTRM's exact
    # mode and RSQO materialize the Hessian by one O(n^2) congruence for
    # sphere problems with quadratic cost and elementwise nonnegativity
    # constraints.
    structure: Optional[dict] = None

    def __post_init__(self):
        if self.manvio is None:
            object.__setattr__(self, "manvio", lambda x: jnp.asarray(0.0))
        if self.callback is None:
            object.__setattr__(self, "callback", lambda problem, x, y, z, ev: ev)

    @property
    def has_ineq(self) -> bool:
        return self.num_ineq > 0

    @property
    def has_eq(self) -> bool:
        return self.num_eq > 0

    # ------------------------------------------------------------------
    # First-order operators
    # ------------------------------------------------------------------
    def egrad(self, x):
        return jax.grad(self.cost)(x)

    def rgrad(self, x):
        return self.manifold.egrad2rgrad(x, self.egrad(x))

    def rhess(self, x, v):
        """Riemannian Hessian-vector product of the cost."""
        eg, eh = jax.jvp(jax.grad(self.cost), (x,), (v,))
        return self.manifold.ehess2rhess(x, eg, eh, v)

    # ------------------------------------------------------------------
    # Constraint values / slack
    # ------------------------------------------------------------------
    def ineq_val(self, x):
        if not self.has_ineq:
            # empty fallback in the COORDINATE dtype: a bare zeros((0,))
            # is f64 under x64 and silently promotes phi/sigma (and then
            # whole solver states) of an f32 problem
            return jnp.zeros((0,), dtype=jax.tree.leaves(x)[0].dtype)
        return self.ineq(x)

    def eq_val(self, x):
        if not self.has_eq:
            return jnp.zeros((0,), dtype=jax.tree.leaves(x)[0].dtype)
        return self.eq(x)

    def slack(self, x):
        """c(x) = -ineq(x); positive at strictly feasible points
        (reference's ``costineqconstvecfun``, ``RIPTRM.py:721``)."""
        return -self.ineq_val(x)

    # ------------------------------------------------------------------
    # Lagrangian operators (all constraints at once)
    # ------------------------------------------------------------------
    def _lag(self, x, y, z):
        val = self.cost(x)
        if self.has_ineq:
            val = val + jnp.vdot(y, self.ineq(x))
        if self.has_eq:
            val = val + jnp.vdot(z, self.eq(x))
        return val

    def lag_egrad(self, x, y, z=None):
        return jax.grad(self._lag)(x, y, z)

    def lag_rgrad(self, x, y, z=None):
        """Riemannian gradient of the Lagrangian
        (reference ``gradLagrangefun``, ``RIPTRM.py:475-489``)."""
        return self.manifold.egrad2rgrad(x, self.lag_egrad(x, y, z))

    def lag_rhess(self, x, y, v, z=None):
        """Riemannian Hessian-vector product of the Lagrangian
        (reference ``hessLagrangefun``, ``RIPTRM.py:491-523``, which loops
        over constraints; here one jvp-of-grad)."""
        eg, eh = jax.jvp(lambda xx: jax.grad(self._lag)(xx, y, z), (x,), (v,))
        return self.manifold.ehess2rhess(x, eg, eh, v)

    # ------------------------------------------------------------------
    # Constraint-Jacobian operators in terms of the slack c = -g
    # ------------------------------------------------------------------
    def gx(self, x, v):
        """Gx(v) = Riemannian gradient of x -> v . c(x) = sum_i v_i * (-grad g_i)
        (reference ``Gxfun``, ``RIPTRM.py:525-551``): one vjp."""
        _, pullback = jax.vjp(self.ineq, x)
        (eg,) = pullback(-v)
        return self.manifold.egrad2rgrad(x, eg)

    def gx_adj(self, x, dx):
        """Gxaj(dx)_i = <-grad g_i, dx> = d/dt c(x + t dx)
        (reference ``Gxajfun``, ``RIPTRM.py:553-571``): one jvp."""
        _, dg = jax.jvp(self.ineq, (x,), (dx,))
        return -dg

    def hx(self, x, v):
        """Equality analog of gx: Riemannian gradient of x -> v . h(x)."""
        _, pullback = jax.vjp(self.eq, x)
        (eg,) = pullback(v)
        return self.manifold.egrad2rgrad(x, eg)

    def hx_adj(self, x, dx):
        _, dh = jax.jvp(self.eq, (x,), (dx,))
        return dh

    # ------------------------------------------------------------------
    # Point-frozen operator factories (hot-loop form).
    #
    # ``jax.linearize``/``jax.vjp`` compute the point-dependent primal trace
    # ONCE; the returned closures are tangent-only, so repeated applications
    # inside tCG / CR / materialization loops carry no redundant work (the
    # per-call forms above re-trace the primal each application).
    # ------------------------------------------------------------------
    def lag_rhess_at(self, x, y, z=None):
        """Returns dx -> Riemannian Hessian-vector product of L at (x,y,z)."""
        eg, lin = jax.linearize(lambda xx: jax.grad(self._lag)(xx, y, z), x)

        def hvp(v):
            return self.manifold.ehess2rhess(x, eg, lin(v), v)

        return hvp

    def gx_adj_at(self, x):
        """Returns dx -> Gxaj(dx) with the constraint primal frozen."""
        _, lin = jax.linearize(self.ineq, x)
        return lambda dx: -lin(dx)

    def gx_at(self, x):
        """Returns v -> Gx(v) with the constraint pullback frozen."""
        _, pullback = jax.vjp(self.ineq, x)

        def gx(v):
            (eg,) = pullback(-v)
            return self.manifold.egrad2rgrad(x, eg)

        return gx
