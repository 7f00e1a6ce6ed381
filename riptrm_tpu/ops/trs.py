"""Exact trust-region subproblem solver (Moré-Sorensen via eigendecomposition).

Parity target: ``TRSgep`` (``/root/reference/src/solver/RIPTRM.py:218-299``),
which solves min 0.5 x'Ax + a'x s.t. x'Bx <= Del^2 through a 2n x 2n
*generalized nonsymmetric* eigenproblem — costly, and without a batched accelerator kernel.

Re-design: the solver operates in metric-orthonormal coordinates
(B = I by construction), so one symmetric ``eigh`` of A plus a safeguarded
Newton iteration on the secular equation gives the global solution,
including the hard case, entirely inside jit with static shapes.

Returns (x, lam, code) with code 0 = interior, 1 = boundary, 2 = hard case,
and lam the Lagrange multiplier of the norm constraint.
"""

from __future__ import annotations

import jax
import jax.numpy as jnp


def solve_trs(A, a, radius, *, newton_iters=60):
    """Global solution of min 0.5 x^T A x + a^T x  s.t. ||x|| <= radius."""
    lam, Q = jnp.linalg.eigh(A)  # ascending
    x, lam_out, code, _ = solve_trs_eig(lam, Q, a, radius, newton_iters=newton_iters)
    return x, lam_out, code


def solve_trs_eig(lam, Q, a, radius, *, newton_iters=60):
    """``solve_trs`` given a precomputed eigendecomposition A = Q diag(lam) Q^T
    (ascending).  Callers that already hold the spectrum — e.g. RIPTRM's
    exact mode, whose second-order criterion needs lam[0] of the same matrix
    — avoid a second dense ``eigh`` per step.  Additionally returns the
    solution's eigenbasis coordinates p_c (x = Q @ p_c), from which the
    model terms x'Ax = p_c'(lam*p_c) and A x = Q (lam*p_c) come for free."""
    dtype = Q.dtype
    n = Q.shape[0]
    b = Q.T @ a
    lam1 = lam[0]
    eps = jnp.finfo(dtype).eps
    scale = jnp.maximum(jnp.max(jnp.abs(lam)), 1.0)

    # ---- interior candidate (A positive definite, unconstrained min inside)
    pos_def = lam1 > eps * scale
    p_int_c = -b / jnp.where(jnp.abs(lam) < eps * scale, 1.0, lam)
    interior_ok = jnp.logical_and(pos_def, jnp.vdot(p_int_c, p_int_c) <= radius**2)

    # ---- secular equation on the boundary: ||p(sig)|| = radius,
    #      p(sig) = -b / (lam + sig),  sig in (max(0, -lam1), inf)
    sig_lb = jnp.maximum(0.0, -lam1)

    def w2(sig):
        d = lam + sig
        d = jnp.where(jnp.abs(d) < eps * scale, eps * scale, d)
        return jnp.sum((b / d) ** 2)

    # Hard case detection: at the left end of the interval the step is still
    # shorter than the radius (the secular equation has no root).  When A is
    # positive definite but the interior step is infeasible, w2(sig_lb+) =
    # ||p_int||^2 > radius^2, so this single predicate also excludes that
    # branch.
    tiny = eps * scale * 16.0
    hard = jnp.logical_and(~interior_ok, w2(sig_lb + tiny) < radius**2)

    # ---- safeguarded Newton on phi(sig) = 1/||p(sig)|| - 1/radius
    sig0 = sig_lb + jnp.linalg.norm(b) / radius + tiny

    def newton_body(_, sig):
        d = lam + sig
        d = jnp.where(d < eps * scale, eps * scale, d)
        w = jnp.sqrt(jnp.sum((b / d) ** 2))
        w = jnp.maximum(w, jnp.finfo(dtype).tiny)
        phi = 1.0 / w - 1.0 / radius
        dphi = jnp.sum(b**2 / d**3) / w**3
        step = phi / jnp.where(dphi == 0, 1.0, dphi)
        sig_new = sig - step
        return jnp.maximum(sig_new, sig_lb + tiny)

    sig = jax.lax.fori_loop(0, newton_iters, newton_body, sig0)
    d = jnp.where(lam + sig < eps * scale, eps * scale, lam + sig)
    p_bnd = -b / d

    # ---- hard case: sig = -lam1; regular part plus eigenvector of lam1
    min_mask = jnp.abs(lam - lam1) <= 16.0 * eps * scale
    d_h = lam - lam1
    d_h = jnp.where(min_mask, 1.0, d_h)
    p_reg = jnp.where(min_mask, 0.0, -b / d_h)
    alpha2 = jnp.maximum(radius**2 - jnp.vdot(p_reg, p_reg), 0.0)
    e1 = jnp.zeros(n, dtype=dtype).at[0].set(1.0)  # coords of q1 in eigenbasis
    p_hard = p_reg + jnp.sqrt(alpha2) * e1

    p_c = jnp.where(interior_ok, p_int_c, jnp.where(hard, p_hard, p_bnd))
    lam_out = jnp.where(interior_ok, 0.0, jnp.where(hard, -lam1, sig))
    code = jnp.where(interior_ok, 0, jnp.where(hard, 2, 1))
    x = Q @ p_c
    return x, lam_out, code, p_c


def solve_trs_ms(A, a, radius, *, lanczos_iters=32, newton_iters=48,
                 inv_iters=6, lam_est=None):
    """Global TRS solution by safeguarded Moré-Sorensen iteration —
    Cholesky factorizations instead of a dense eigendecomposition.

    A dense ``eigh`` (tridiagonalization plus an iterative eigensolver)
    costs far more than one ``cholesky`` or a short dense Lanczos of the
    same matrix, so at large dim the eigh-based exact mode is eigh-bound.
    This solver needs a handful of factorizations:

    1. lambda extremes estimated by dense Lanczos (Ritz values; the min
       approaches lambda_1 from above, so PD/shift decisions are CERTIFIED
       by Cholesky success, never assumed from the estimate);
    2. interior candidate: if A factors at shift 0 and ||A^{-1}a|| <= radius
       the unconstrained minimizer wins (code 0);
    3. otherwise safeguarded Newton on the secular equation
       phi(sig) = 1/||p(sig)|| - 1/radius with p(sig) = -(A + sig I)^{-1} a:
       each iteration one ``cho_factor`` + two triangular solves; a
       non-finite factor tightens the bracket's lower edge instead of
       poisoning the iterate (branchless);
    4. hard case (the secular equation has no root above -lambda_1): the
       boundary completion p + tau*v along an inverse-iteration eigenvector
       of lambda_1 (code 2).

    Returns (x, lam, code, mineig_est) — same contract as ``solve_trs``
    plus the Lanczos lambda_min estimate (callers use it for the
    second-order criterion; it is the same Ritz-from-above certificate
    character as the tCG mode's matrix-free Lanczos).

    Reference semantics target: ``TRSgep`` (``RIPTRM.py:218-299``) — the
    solution matches ``solve_trs`` at solver tolerance on all three case
    classes (tests/test_trs.py).
    """
    from jax.scipy.linalg import cho_factor, cho_solve, solve_triangular

    from riptrm_tpu.ops.spectrum import lanczos

    dtype = A.dtype
    n = A.shape[0]
    eps = jnp.finfo(dtype).eps
    scale = jnp.maximum(jnp.max(jnp.abs(A)), 1.0)
    norm_a = jnp.linalg.norm(a)
    eye = jnp.eye(n, dtype=dtype)

    # ---- Lanczos extremes (deterministic start: 'a' mixed with a fixed
    # direction so a gradient orthogonal to the lam_1 eigenvector — the
    # hard-case geometry — cannot deflate the Krylov space away from it)
    ones = jnp.ones((n,), dtype=dtype) / jnp.sqrt(jnp.asarray(n, dtype))
    if lam_est is None:
        ramp = jnp.linspace(0.5, 1.5, n, dtype=dtype)
        mix = ones + 1e-3 * ramp
        v0 = jnp.where(
            norm_a > eps * scale,
            a / jnp.maximum(norm_a, eps) + 0.05 * mix,
            mix,
        )
        v0 = v0 / jnp.linalg.norm(v0)
        k = min(lanczos_iters, n)
        _, _, ritz = lanczos(lambda v: A @ v, v0, lambda u, w: u @ w, k)
        lam_min_est, lam_max_est = ritz[0], ritz[-1]
    else:
        # caller-supplied extremes (e.g. RIPTRM's exact-mode cache, which
        # already ran the dense Lanczos at materialization time)
        lam_min_est, lam_max_est = lam_est

    # ---- interior candidate (certified by Cholesky success at shift 0)
    cf0 = cho_factor(A)
    pd0 = jnp.all(jnp.isfinite(cf0[0]))
    safe_cf0 = (jnp.where(pd0, cf0[0], eye), cf0[1])
    p_int = jnp.where(pd0, cho_solve(safe_cf0, -a), jnp.zeros_like(a))
    interior_ok = pd0 & (jnp.vdot(p_int, p_int) <= radius**2)

    # ---- safeguarded Newton bracket
    # sigma* lies in [max(0, -lam_1), ||a||/radius - lam_1]; use the Ritz
    # estimate minus a slack for the lower edge (Ritz >= lam_1) and let
    # factorization failures raise it.
    slack = 16.0 * eps * scale + 1e-3 * jnp.abs(lam_min_est)
    lo0 = jnp.maximum(0.0, -lam_min_est)  # may be BELOW the true -lam_1
    hi0 = jnp.maximum(norm_a / jnp.maximum(radius, eps) - lam_min_est + slack,
                      lo0 + slack)
    # start inside the analytic window sigma* in
    # [||a||/radius - lam_max, ||a||/radius - lam_min]: from the
    # ||p|| > radius side Newton on the secular equation is monotone and
    # quadratically convergent
    sig0 = jnp.clip(
        norm_a / jnp.maximum(radius, eps) - lam_max_est,
        lo0 + slack, hi0 - slack,
    )
    # exit when ||p|| is on the boundary to ~sqrt-of-solve accuracy: the
    # Newton fixed point wanders at the linear-solve noise level, so a
    # 32*eps target is unreachable in f64 and the safeguard would kick a
    # converged iterate away (measured: bisection blow-away after
    # convergence).  f32: 3.8e-6 relative; f64: 1e-11.
    rtol = jnp.maximum(32.0 * eps, 1e-11)

    def body(carry):
        # Carry keeps (sig, p(sig), ||p(sig)||) IN SYNC: convergence is
        # checked on the p just solved at the carried sigma, so no final
        # tightening factorization is needed after the loop (the earlier
        # lagged-p formulation paid one extra cho_factor per TRS call).
        sig, lo, hi, p, np_, ok_any, k, _sn = carry
        cf = cho_factor(A + sig * eye)
        finite = jnp.all(jnp.isfinite(cf[0]))
        safe_l = jnp.where(finite, cf[0], eye)
        p_try = cho_solve((safe_l, cf[1]), -a)
        np_try = jnp.linalg.norm(p_try)
        # q = L^{-1} p  =>  ||q||^2 = p' (A + sig I)^{-1} p
        q = solve_triangular(safe_l, p_try, lower=cf[1], trans=0)
        nq2 = jnp.maximum(jnp.vdot(q, q), jnp.finfo(dtype).tiny)
        # Newton step on 1/||p|| - 1/radius (More-Sorensen form)
        dsig = (np_try**2 / nq2) * (np_try - radius) / jnp.maximum(
            radius, eps
        )
        # bracket update: non-finite factor or ||p|| > radius => sig too
        # small in the first case, inside the bracket in the second
        lo_new = jnp.where(~finite, jnp.maximum(lo, sig),
                           jnp.where(np_try > radius, jnp.maximum(lo, sig), lo))
        hi_new = jnp.where(finite & (np_try <= radius), jnp.minimum(hi, sig), hi)
        sig_newton = sig + jnp.where(finite, dsig, 0.0)
        # inclusive bracket + tiny-step passthrough: at convergence the
        # bracket edge IS the iterate and exclusive bounds would bisect
        # away from the solution
        inside = (sig_newton >= lo_new) & (sig_newton <= hi_new)
        tiny_step = jnp.abs(dsig) <= 64.0 * eps * (jnp.abs(sig) + 1.0)
        sig_next = jnp.where(
            finite & (inside | tiny_step), sig_newton, 0.5 * (lo_new + hi_new)
        )
        sig_keep = jnp.where(finite, sig, _sn)  # sigma p corresponds to
        p_keep = jnp.where(finite, p_try, p)
        np_keep = jnp.where(finite, np_try, np_)
        return (sig_next, lo_new, hi_new, p_keep, np_keep,
                ok_any | finite, k + 1, sig_keep)

    def cond(carry):
        sig, lo, hi, p, np_, ok_any, k, _sn = carry
        done = ok_any & (jnp.abs(np_ - radius) <= rtol * radius)
        # interior_ok: the unconstrained minimizer wins and the secular
        # equation has no boundary root — without this gate an interior
        # step burned ALL newton_iters factorizations whose result was
        # then discarded for p_int (measured: the dominant cost of
        # late-solve exact-mode steps, where PD Hessians + small gradients
        # make interior steps the common case).
        return (~interior_ok) & (~done) & (k < newton_iters)

    init = (sig0, lo0, hi0, jnp.zeros_like(a), jnp.asarray(0.0, dtype),
            jnp.asarray(False), jnp.asarray(0), sig0)
    _, lo, hi, p_bnd, np_bnd, ok_any, _, sig = jax.lax.while_loop(
        cond, body, init
    )

    # ---- hard case: converged onto the bracket's lower edge with the
    # step still interior — complete to the boundary along the lam_1
    # eigenvector (inverse iteration at a freshly certified shift).
    # Gated behind lax.cond: the common easy-boundary case skips the extra
    # factorization + inv_iters solves entirely (under vmap the cond
    # lowers to a select and both branches run — the single-lane exact
    # mode is where this saves ~1/3 of the TRS time).
    hard = (~interior_ok) & ok_any & (np_bnd < (1.0 - 1e-4) * radius)

    def hard_completion(_):
        cf_h = cho_factor(A + (sig + slack) * eye)
        finite_h = jnp.all(jnp.isfinite(cf_h[0]))
        safe_h = (jnp.where(finite_h, cf_h[0], eye), cf_h[1])

        def inv_body(v, _):
            w = cho_solve(safe_h, v)
            return w / jnp.maximum(
                jnp.linalg.norm(w), jnp.finfo(dtype).tiny
            ), None

        v_min, _ = jax.lax.scan(inv_body, ones, None, length=inv_iters)
        # boundary completion ||p + tau v|| = radius (pick the root with
        # smaller model value: tau sign against p'v)
        pv = jnp.vdot(p_bnd, v_min)
        disc = jnp.maximum(pv**2 + radius**2 - np_bnd**2, 0.0)
        tau = jnp.where(pv > 0, -pv - jnp.sqrt(disc), -pv + jnp.sqrt(disc))
        return p_bnd + tau * v_min

    p_hard = jax.lax.cond(
        hard, hard_completion, lambda _: p_bnd, operand=None
    )

    x = jnp.where(interior_ok, p_int, jnp.where(hard, p_hard, p_bnd))
    lam_out = jnp.where(interior_ok, 0.0, sig)
    code = jnp.where(interior_ok, 0, jnp.where(hard, 2, 1))
    return x, lam_out, code, lam_min_est
