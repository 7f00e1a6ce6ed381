"""Unconstrained Riemannian subsolvers: steepest descent and conjugate
gradient with backtracking line search.

Parity target: ``pymanopt.optimizers.SteepestDescent`` /
``ConjugateGradient`` as consumed by RALM
(``/root/reference/src/solver/RALM.py:180-188``): backtracking Armijo line
search with optimism-based warm-started step size, stopping on
``min_gradient_norm`` / ``max_iterations`` / ``min_step_size``.

Design: the whole optimizer is one ``lax.while_loop`` (line search is a
nested while_loop), so RALM's inner solve compiles into the outer step.
"""

from __future__ import annotations

from typing import Callable, NamedTuple

import jax
import jax.numpy as jnp


class _LSResult(NamedTuple):
    x_new: object
    f_new: jnp.ndarray
    alpha: jnp.ndarray
    step_count: jnp.ndarray


def _backtracking_line_search(
    manifold,
    cost,
    x,
    d,
    f0,
    df0,
    alpha0,
    *,
    contraction=0.5,
    sufficient_decrease=1e-4,
    max_steps=25,
):
    """pymanopt BackTrackingLineSearcher semantics."""

    def try_alpha(alpha):
        x_new = manifold.retract(x, jax.tree.map(lambda a: alpha * a, d))
        return x_new, cost(x_new)

    x1, f1 = try_alpha(alpha0)

    def cond(carry):
        alpha, x_new, f_new, k = carry
        armijo_fail = f_new > f0 + sufficient_decrease * alpha * df0
        return jnp.logical_and(armijo_fail, k <= max_steps)

    def body(carry):
        alpha, _, _, k = carry
        alpha = alpha * contraction
        x_new, f_new = try_alpha(alpha)
        return (alpha, x_new, f_new, k + 1)

    alpha, x_new, f_new, k = jax.lax.while_loop(
        cond, body, (alpha0, x1, f1, jnp.asarray(1))
    )
    # pymanopt: if no decrease at all, refuse the step.
    no_step = f_new > f0
    x_new = jax.tree.map(
        lambda n, o: jnp.where(no_step, o, n), x_new, x
    )
    f_new = jnp.where(no_step, f0, f_new)
    alpha = jnp.where(no_step, 0.0, alpha)
    return _LSResult(x_new, f_new, alpha, k)


class SubsolverResult(NamedTuple):
    point: object
    cost: jnp.ndarray
    gradient_norm: jnp.ndarray
    iterations: jnp.ndarray


def steepest_descent(
    manifold,
    cost: Callable,
    rgrad: Callable,
    x0,
    *,
    max_iterations=200,
    min_gradient_norm=1e-6,
    min_step_size=1e-10,
    initial_step_size=1.0,
    optimism=2.0,
) -> SubsolverResult:
    """Riemannian steepest descent, fully jittable."""

    class State(NamedTuple):
        x: object
        g: object  # gradient at x (one rgrad per iteration, pymanopt-style)
        f: jnp.ndarray
        oldf: jnp.ndarray
        have_oldf: jnp.ndarray
        stepsize: jnp.ndarray
        gradnorm: jnp.ndarray
        k: jnp.ndarray

    f0 = cost(x0)
    g0 = rgrad(x0)
    st0 = State(
        x=x0,
        g=g0,
        f=f0,
        oldf=f0,
        have_oldf=jnp.asarray(False),
        stepsize=jnp.asarray(jnp.inf, dtype=f0.dtype),
        gradnorm=manifold.norm(x0, g0),
        k=jnp.asarray(0),
    )

    def cond(st):
        return (
            (st.gradnorm >= min_gradient_norm)
            & (st.stepsize >= min_step_size)
            & (st.k < max_iterations)
        )

    def body(st):
        d = jax.tree.map(lambda a: -a, st.g)
        df0 = -(st.gradnorm**2)
        # warm-started initial step (pymanopt optimism rule)
        alpha_warm = jnp.where(
            st.have_oldf,
            optimism * 2.0 * (st.f - st.oldf) / jnp.where(df0 == 0, 1.0, df0),
            initial_step_size / jnp.maximum(st.gradnorm, 1e-30),
        )
        alpha_warm = jnp.maximum(alpha_warm, 1e-30)
        ls = _backtracking_line_search(
            manifold, cost, st.x, d, st.f, df0, alpha_warm
        )
        g_new = rgrad(ls.x_new)
        return State(
            x=ls.x_new,
            g=g_new,
            f=ls.f_new,
            oldf=st.f,
            have_oldf=jnp.asarray(True),
            stepsize=ls.alpha * st.gradnorm,
            gradnorm=manifold.norm(ls.x_new, g_new),
            k=st.k + 1,
        )

    st = jax.lax.while_loop(cond, body, st0)
    return SubsolverResult(st.x, st.f, st.gradnorm, st.k)


def conjugate_gradient(
    manifold,
    cost: Callable,
    rgrad: Callable,
    x0,
    *,
    max_iterations=200,
    min_gradient_norm=1e-6,
    min_step_size=1e-10,
    initial_step_size=1.0,
    optimism=2.0,
) -> SubsolverResult:
    """Riemannian conjugate gradient (Polak-Ribiere+ with projection-based
    vector transport) with the same backtracking line search."""

    class State(NamedTuple):
        x: object
        f: jnp.ndarray
        oldf: jnp.ndarray
        have_oldf: jnp.ndarray
        g: object
        d: object
        stepsize: jnp.ndarray
        gradnorm: jnp.ndarray
        k: jnp.ndarray

    f0 = cost(x0)
    g0 = rgrad(x0)
    st0 = State(
        x=x0,
        f=f0,
        oldf=f0,
        have_oldf=jnp.asarray(False),
        g=g0,
        d=jax.tree.map(lambda a: -a, g0),
        stepsize=jnp.asarray(jnp.inf, dtype=f0.dtype),
        gradnorm=manifold.norm(x0, g0),
        k=jnp.asarray(0),
    )

    def cond(st):
        return (
            (st.gradnorm >= min_gradient_norm)
            & (st.stepsize >= min_step_size)
            & (st.k < max_iterations)
        )

    def body(st):
        df0 = manifold.inner(st.x, st.g, st.d)
        # fall back to steepest descent when d is not a descent direction
        use_sd = df0 >= 0
        d = jax.tree.map(
            lambda di, gi: jnp.where(use_sd, -gi, di), st.d, st.g
        )
        df0 = jnp.where(use_sd, -(st.gradnorm**2), df0)
        alpha_warm = jnp.where(
            st.have_oldf,
            optimism * 2.0 * (st.f - st.oldf) / jnp.where(df0 == 0, 1.0, df0),
            initial_step_size / jnp.maximum(st.gradnorm, 1e-30),
        )
        alpha_warm = jnp.maximum(alpha_warm, 1e-30)
        ls = _backtracking_line_search(manifold, cost, st.x, d, st.f, df0, alpha_warm)
        x_new = ls.x_new
        g_new = rgrad(x_new)
        gradnorm_new = manifold.norm(x_new, g_new)
        # transport previous grad/direction (projection transport by default;
        # structured transport on factored manifolds like fixed-rank)
        g_old_t = manifold.transport(st.x, x_new, st.g)
        d_t = manifold.transport(st.x, x_new, d)
        diff = jax.tree.map(lambda a, b: a - b, g_new, g_old_t)
        beta = jnp.maximum(
            manifold.inner(x_new, g_new, diff) / jnp.maximum(st.gradnorm**2, 1e-300),
            0.0,
        )
        d_new = jax.tree.map(lambda gn, dt: -gn + beta * dt, g_new, d_t)
        return State(
            x=x_new,
            f=ls.f_new,
            oldf=st.f,
            have_oldf=jnp.asarray(True),
            g=g_new,
            d=d_new,
            stepsize=ls.alpha * manifold.norm(st.x, d),
            gradnorm=gradnorm_new,
            k=st.k + 1,
        )

    st = jax.lax.while_loop(cond, body, st0)
    return SubsolverResult(st.x, st.f, st.gradnorm, st.k)
