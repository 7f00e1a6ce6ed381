"""Spectra of tangent-space operators.

Parity targets: ``hessianspectrum`` (``/root/reference/src/solver/utils.py:417-475``)
and ``operatorspectrum`` (``utils.py:477-530``), which route through SciPy's
ARPACK ``eigs`` on a LinearOperator — unavailable under jit on an accelerator.

Jittable replacements:
* ``operator_spectrum``: materialize the (self-adjoint) operator in the
  deterministic metric-orthonormal basis with one batched vmap and run a
  symmetric ``eigh`` — exact, O(dim) operator applications, ideal for the
  reference's problem sizes (dim <= a few thousand).
* ``lanczos``: matrix-free Lanczos with full reorthogonalization for
  extreme eigenvalues of very large operators where materialization is too
  expensive; one ``lax.scan``.
"""

from __future__ import annotations

import jax
import jax.flatten_util  # explicit: not loaded by `import jax` alone
import jax.numpy as jnp

from riptrm_tpu.ops.basis import materialize_symmetrized


def operator_spectrum(manifold, x, op, *, descending_abs=True):
    """Eigen-decomposition of a self-adjoint tangent-space operator.

    Returns (w, V) where V is the stacked eigen tangent-vectors
    [dim, ...point shape...] via the coords API.  Ordering matches the
    reference: by |eigenvalue| descending (``utils.py:522-527``) unless
    ``descending_abs=False`` (ascending).
    """
    basis = manifold.basis(x)
    a = materialize_symmetrized(manifold, x, basis, op)
    w, v = jnp.linalg.eigh(a)  # ascending
    if descending_abs:
        order = jnp.argsort(-jnp.abs(w))
        w = w[order]
        v = v[:, order]
    vecs = jax.vmap(lambda c: manifold.from_coords(x, basis, c))(v.T)
    return w, vecs


def hessian_spectrum(problem, x, *, descending_abs=True):
    """Spectrum of the Riemannian Hessian of the cost
    (reference ``hessianspectrum``)."""
    return operator_spectrum(
        problem.manifold, x, lambda v: problem.rhess(x, v), descending_abs=descending_abs
    )


def lanczos(matvec, v0, inner, num_iters: int):
    """Matrix-free Lanczos tridiagonalization with full reorthogonalization.

    ``matvec``: tangent -> tangent (self-adjoint w.r.t. ``inner``);
    ``v0``: start vector (pytree); ``inner(u, w)``: metric inner product.
    Returns (alphas [k], betas [k-1], ritz_values [k]) — extreme Ritz
    values approximate the operator's extreme eigenvalues.

    The recurrence runs in the *metric* geometry: ``inner`` is bilinear, so
    the metric apply M w = grad_u <u, w> is exact via one AD pass, and all
    dots/orthogonalizations use q_i' M q_j.  On flat-metric manifolds
    (sphere/Stiefel/Grassmann/Euclidean/skew) M is the identity and this
    reduces to classical Lanczos; on SPD's affine-invariant metric the flat
    recurrence would tridiagonalize a non-symmetric operator and its Ritz
    values would certify nothing.

    Krylov breakdown (the start vector spans an invariant subspace of
    dimension d < num_iters) is masked: steps after breakdown contribute
    ``alphas[0]`` diagonal entries with zero coupling, a Rayleigh quotient
    of the restricted operator, so the extreme Ritz values are unaffected
    (padding with zero rows would inject spurious zero eigenvalues).
    """
    flat0, unravel = jax.flatten_util.ravel_pytree(v0)
    n = flat0.shape[0]
    dt = flat0.dtype
    eps = jnp.finfo(dt).eps

    def m_flat(w_flat):
        w = unravel(w_flat)
        mw = jax.grad(lambda u: inner(u, w))(w)
        return jax.flatten_util.ravel_pytree(mw)[0]

    def mv_flat(q):
        out = matvec(unravel(q))
        return jax.flatten_util.ravel_pytree(out)[0]

    m0 = m_flat(flat0)
    nrm0 = jnp.sqrt(jnp.maximum(jnp.vdot(flat0, m0), jnp.finfo(dt).tiny))
    q0 = flat0 / nrm0
    mq0 = m0 / nrm0

    def body(carry, i):
        Q, MQ, q_prev, mq_prev, q, mq, beta_prev, alive = carry
        w = mv_flat(q)
        mw = m_flat(w)
        alpha = jnp.vdot(mq, w)  # <q, Aq>_M
        r = w - alpha * q - beta_prev * q_prev
        mr = mw - alpha * mq - beta_prev * mq_prev
        # full reorthogonalization against the stored basis (M-metric):
        # c_j = <q_j, r>_M = (M q_j)' r
        coeff = MQ @ r
        r = r - Q.T @ coeff
        mr = mr - MQ.T @ coeff
        beta = jnp.sqrt(jnp.maximum(jnp.vdot(r, mr), 0.0))
        wnorm = jnp.sqrt(jnp.maximum(jnp.vdot(w, mw), 0.0))
        alive_next = alive & (beta > 100.0 * eps * jnp.maximum(wnorm, 1.0))
        safe_beta = jnp.where(beta > 0, beta, 1.0)
        q_next = r / safe_beta
        mq_next = mr / safe_beta
        Q = Q.at[i].set(q)
        MQ = MQ.at[i].set(mq)
        return (Q, MQ, q, mq, q_next, mq_next, beta, alive_next), (
            alpha,
            beta,
            alive,
        )

    Q0 = jnp.zeros((num_iters, n), dtype=dt)
    zero = jnp.zeros_like(q0)
    _, (alphas, betas, alive) = jax.lax.scan(
        body,
        (Q0, Q0, zero, zero, q0, mq0, jnp.asarray(0.0, dt), jnp.asarray(True)),
        jnp.arange(num_iters),
    )
    # Mask the post-breakdown block: alphas[0] (always valid) on the
    # diagonal, decoupled from the live block.
    alphas_v = jnp.where(alive, alphas, alphas[0])
    betas_v = jnp.where(alive[1:], betas[:-1], 0.0)
    t = jnp.diag(alphas_v) + jnp.diag(betas_v, 1) + jnp.diag(betas_v, -1)
    ritz = jnp.linalg.eigvalsh(t)
    return alphas_v, betas_v, ritz
