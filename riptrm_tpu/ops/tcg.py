"""Steihaug-Toint truncated conjugate gradient on a tangent space.

Parity target: the vendored pymanopt tCG in the reference
(``/root/reference/src/solver/RIPTRM.py:41-216``, ``use_rand=False`` path),
re-designed as a single ``lax.while_loop`` so the whole subproblem solve
compiles into one XLA program (one Hessian-vector product per iteration).

Stop codes:
  0 MAX_INNER_ITER, 1 NEGATIVE_CURVATURE, 2 EXCEEDED_TR, 3 MODEL_INCREASED,
  4 REACHED_TARGET_LINEAR, 5 REACHED_TARGET_SUPERLINEAR
"""

from __future__ import annotations

from functools import partial
from typing import NamedTuple

import jax
import jax.numpy as jnp

STOP_MAX_ITER = 0
STOP_NEG_CURV = 1
STOP_EXCEEDED_TR = 2
STOP_MODEL_INCREASED = 3
STOP_TARGET_LINEAR = 4
STOP_TARGET_SUPERLINEAR = 5


def _safe_div(a, b):
    return a / jnp.where(b == 0, 1.0, b)


def _axpy(alpha, x, y):
    """y + alpha * x on pytrees."""
    return jax.tree.map(lambda xi, yi: yi + alpha * xi, x, y)


def truncated_cg(
    manifold,
    x,
    hess,
    grad,
    radius,
    *,
    theta=1.0,
    kappa=0.1,
    mininner=1,
    maxinner=None,
    precond=None,
):
    """Minimize m(eta) = <grad, eta> + 0.5 <eta, hess(eta)> s.t. ||eta|| <= radius.

    Returns (eta, Heta, iterations, stop_code).
    """
    if maxinner is None:
        maxinner = manifold.dim
    if precond is None:
        precond = lambda v: v

    inner = partial(manifold.inner, x)

    eta0 = manifold.zero_vector(x)
    r0 = grad
    norm_r0 = jnp.sqrt(inner(r0, r0))
    z0 = precond(r0)
    z_r0 = inner(z0, r0)
    delta0 = jax.tree.map(lambda a: -a, z0)

    target = norm_r0 * jnp.minimum(norm_r0**theta, kappa)

    class State(NamedTuple):
        eta: object
        Heta: object
        r: object
        delta: object
        e_Pe: jnp.ndarray
        d_Pd: jnp.ndarray
        e_Pd: jnp.ndarray
        z_r: jnp.ndarray
        model_value: jnp.ndarray
        j: jnp.ndarray
        code: jnp.ndarray
        done: jnp.ndarray

    zero = jnp.zeros_like(norm_r0)
    st0 = State(
        eta=eta0,
        Heta=manifold.zero_vector(x),
        r=r0,
        delta=delta0,
        e_Pe=zero,
        d_Pd=z_r0,
        e_Pd=zero,
        z_r=z_r0,
        model_value=zero,
        j=jnp.asarray(0),
        code=jnp.asarray(STOP_MAX_ITER),
        done=jnp.asarray(False),
    )

    def cond(st):
        return jnp.logical_and(~st.done, st.j < maxinner)

    def body(st):
        Hdelta = hess(st.delta)
        d_Hd = inner(st.delta, Hdelta)
        alpha = _safe_div(st.z_r, d_Hd)
        e_Pe_new = st.e_Pe + 2.0 * alpha * st.e_Pd + alpha**2 * st.d_Pd

        bail = jnp.logical_or(d_Hd <= 0, e_Pe_new >= radius**2)
        # Boundary step to the trust-region edge.
        disc = jnp.maximum(st.e_Pd**2 + st.d_Pd * (radius**2 - st.e_Pe), 0.0)
        tau = _safe_div(-st.e_Pd + jnp.sqrt(disc), st.d_Pd)

        eta_b = _axpy(tau, st.delta, st.eta)
        Heta_b = _axpy(tau, Hdelta, st.Heta)

        eta_c = _axpy(alpha, st.delta, st.eta)
        Heta_c = _axpy(alpha, Hdelta, st.Heta)
        model_c = inner(eta_c, grad) + 0.5 * inner(eta_c, Heta_c)
        model_inc = model_c >= st.model_value

        r_new = _axpy(alpha, Hdelta, st.r)
        norm_r = jnp.sqrt(inner(r_new, r_new))
        hit_target = jnp.logical_and(st.j + 1 > mininner, norm_r <= target)

        z_new = precond(r_new)
        z_r_new = inner(z_new, r_new)
        beta = _safe_div(z_r_new, st.z_r)
        delta_new = manifold.proj_tangent(
            x, jax.tree.map(lambda z, d: -z + beta * d, z_new, st.delta)
        )

        done_now = bail | model_inc | hit_target
        code = jnp.where(
            bail,
            jnp.where(d_Hd <= 0, STOP_NEG_CURV, STOP_EXCEEDED_TR),
            jnp.where(
                model_inc,
                STOP_MODEL_INCREASED,
                jnp.where(
                    hit_target,
                    jnp.where(
                        kappa < norm_r0**theta,
                        STOP_TARGET_LINEAR,
                        STOP_TARGET_SUPERLINEAR,
                    ),
                    STOP_MAX_ITER,
                ),
            ),
        )

        def sel(a_bail, a_keep, a_accept):
            return jax.tree.map(
                lambda b_, k_, a_: jnp.where(bail, b_, jnp.where(model_inc, k_, a_)),
                a_bail,
                a_keep,
                a_accept,
            )

        eta_out = sel(eta_b, st.eta, eta_c)
        Heta_out = sel(Heta_b, st.Heta, Heta_c)

        return State(
            eta=eta_out,
            Heta=Heta_out,
            r=r_new,
            delta=delta_new,
            e_Pe=jnp.where(done_now, st.e_Pe, e_Pe_new),
            d_Pd=jnp.where(done_now, st.d_Pd, z_r_new + beta**2 * st.d_Pd),
            e_Pd=jnp.where(done_now, st.e_Pd, beta * (st.e_Pd + alpha * st.d_Pd)),
            z_r=jnp.where(done_now, st.z_r, z_r_new),
            model_value=jnp.where(done_now | model_inc, st.model_value, model_c),
            j=st.j + 1,
            code=code,
            done=done_now,
        )

    with jax.named_scope("tcg"):  # names the loop's kernels in traces
        st = jax.lax.while_loop(cond, body, st0)
    return st.eta, st.Heta, st.j, st.code
