"""Jittable dense convex QP solver (primal-dual Mehrotra predictor-corrector).

Replaces CVXOPT's ``solvers.qp`` used by RSQO
(``/root/reference/src/solver/RSQO.py:196-208``):

    minimize    0.5 d^T Q d + p^T d
    subject to  G d <= h,   A d = b

with Q symmetric positive definite (RSQO regularizes it first — the clamp
at ``RSQO.py:126-131`` guarantees eigenvalues >= quadoptim_eigvalcorr > 0,
and this solver EXPLOITS that: the condensed Newton matrix
M = Q + G^T diag(z/s) G is then SPD, so each IPM iteration does ONE
Cholesky factorization shared by the predictor and corrector solves, with
equality constraints eliminated through an SPD Schur complement — instead
of two general LU solves of the full saddle-point block per iteration.
Returns the primal solution and both multiplier vectors, matching the
CVXOPT outputs the reference consumes (``sol['x']``, ``sol['z']``,
``sol['y']``).

Design: fixed-shape dense linear algebra, ``lax.while_loop`` with
tolerance-based early exit — the whole solve stays inside the surrounding
jitted solver step and batches cleanly under ``vmap`` (batched Cholesky /
triangular solves batch as matrix kernels; frozen lanes mask out via the while_loop
batching rule).  ``warm_z`` warm-starts the dual from the surrounding SQP
iteration's multipliers: near SQP convergence the start (x=0, s=max(h,eps),
z=y_prev) is already primal-feasible with a near-stationary dual, cutting
the IPM to a handful of iterations (the reference's CVXOPT cold-starts
every QP).
"""

from __future__ import annotations

from typing import NamedTuple

import jax
import jax.numpy as jnp
from jax.scipy.linalg import cho_factor, cho_solve


class QpResult(NamedTuple):
    x: jnp.ndarray
    z: jnp.ndarray  # inequality multipliers (>= 0)
    y: jnp.ndarray  # equality multipliers
    s: jnp.ndarray  # slacks (>= 0)
    iterations: jnp.ndarray
    gap: jnp.ndarray
    primal_infeasibility: jnp.ndarray
    dual_infeasibility: jnp.ndarray
    status: jnp.ndarray  # 0 = optimal, 1 = max-iter, 2 = NaN-frozen (f32)
    xinv: object = None  # method='schulz': warm-start inverse for the next QP


# Newton-Schulz inverse maintenance (method='schulz') constants: refresh
# until ||M X - I||_F <= TOL (the final update squares that residual, so
# the working inverse sits at ~TOL^2), give up after MAX steps (a cold
# t*I start needs ~log2(cond) + log2(sqrt(n)) + 4 iterations — 64 covers
# cond ~1e14 at n~1000, i.e. anything f64 can resolve; warm starts and
# per-IPM-iteration refreshes need 1-3, so the warm sweep gets a small
# budget (WARM_MAX) and a stale inverse fails fast to the scaled-identity
# reset instead of burning 64 n^3 sweeps in vmap lockstep.
# An inverse is USABLE only at err <= sqrt(TOL): below that the two
# Richardson refinement sweeps leave a relative direction error
# ~ err^3 <= 3.2% — a budget-exhausted sweep stuck at err in
# (sqrt(TOL), 1] used to slip through the old err <= 1 gate and burn the
# IPM's remaining maxiter on near-useless O(1)-error steps.
_SCHULZ_TOL = 0.1
_SCHULZ_MAX = 64
_SCHULZ_WARM_MAX = 8
_SCHULZ_USABLE = 0.31622776601  # sqrt(_SCHULZ_TOL)


def solve_qp(Q, p, G, h, A=None, b=None, *, abstol=1e-10, reltol=1e-10,
             feastol=1e-10, maxiter=50, warm_z=None, method="chol",
             xinv0=None):
    """Solve the QP; all shapes static.  ``A``/``b`` may be (0, n)/(0,).

    Q must be symmetric POSITIVE DEFINITE (the Newton systems are solved by
    Cholesky; an indefinite Q yields NaNs, not an error) and A full row
    rank.  ``warm_z`` (optional, shape (m,)) warm-starts the inequality
    multipliers, e.g. from the previous QP of an SQP sequence.

    ``method``: 'chol' (default) factors the condensed SPD Newton matrix
    M = Q + G' diag(z/s) G once per IPM iteration, shared by predictor and
    corrector — the fast batched path.  'lu' solves the same condensed
    system by partial-pivot LU (saddle block when A is nonempty): near the
    central path's end diag(z/s) spans ~16 decades and the Cholesky of the
    numerically-indefinite-by-rounding M loses the last digits, which at
    1e-15-deep SQP targets is enough to stall the outer iteration (measured
    on StableIdentification: the Cholesky path plateaus lanes at 1e-2/1e-13
    that the LU path drives to the 3.3e-15 reference floor).  Deep-parity
    f64 runs should use 'lu'; chip-sweep f32 runs never resolve those
    digits and keep the ~40%-faster 'chol'.

    'schulz' (inequality-only QPs, A empty) never factorizes at all: it
    maintains X ~= M^{-1} across IPM iterations by Newton-Schulz iteration
    X <- X (2I - M X) (quadratic convergence while ||I - M X|| < 1) and
    solves each Newton system as dx = X rhs plus two Richardson refinement
    sweeps (relative direction error ~ ||I-XM||^3 ~ 1e-6 at the working
    residual).  Everything is batched [n,n] matmuls, so under ``vmap`` the
    whole QP is batched matrix products and aggregate throughput SCALES with batch
    width — unlike the 'chol' path, whose batched Cholesky is
    column-sequential and scales O(B).  ``xinv0`` warm-starts X from the
    previous QP of an SQP sequence (pass ``QpResult.xinv`` back in; an
    all-zero ``xinv0`` means cold — X starts at I/||M||_inf and the first
    IPM iteration pays the ~log2(cond) bootstrap).  A refresh that fails
    to contract (warm X too stale, or f32 overflow) resets to the scaled
    identity and re-bootstraps once; if even that diverges the lane is
    frozen at its last finite iterate (status 2), same contract as the
    NaN-freeze.
    """
    dtype = Q.dtype
    n = Q.shape[0]
    m = G.shape[0]
    if A is None:
        A = jnp.zeros((0, n), dtype=dtype)
        b = jnp.zeros((0,), dtype=dtype)
    l = A.shape[0]

    scale = jnp.maximum(1.0, jnp.linalg.norm(h) / max(m, 1))
    x0 = jnp.zeros((n,), dtype=dtype)
    y0 = jnp.zeros((l,), dtype=dtype)
    if warm_z is None:
        # cold start: s = z = scaled ones (infeasible-start IPM)
        s0 = jnp.full((m,), scale, dtype=dtype)
        z0 = jnp.full((m,), 1.0, dtype=dtype)
    else:
        # warm start at x = 0: s = h makes the primal residual exactly zero
        # whenever h >= 0 (the SQP iterate is feasible); z carries the
        # caller's multipliers.  Both are floored away from the boundary so
        # the first centering step is not blocked.
        s0 = jnp.maximum(h, 1e-2 * scale).astype(dtype)
        z0 = jnp.maximum(jnp.asarray(warm_z, dtype=dtype), 1e-4)

    def residuals(x, s, z, y):
        rd = Q @ x + p + G.T @ z + A.T @ y
        rp = G @ x + s - h
        re = A @ x - b
        return rd, rp, re

    use_polish = method == "schulz_polish"
    use_lu = method == "lu"
    use_schulz = method == "schulz" or use_polish
    if use_schulz and l > 0:
        raise ValueError(
            "method='schulz' supports inequality-only QPs (A must be empty);"
            " use 'chol' or 'lu' when equality constraints are present"
        )
    eye_n = jnp.eye(n, dtype=dtype) if use_schulz else None

    def build_m(s, z):
        w = z / s
        return Q + (G.T * w) @ G

    def _schulz_sweep(X, M, err0, max_iter):
        """Newton-Schulz until ||M X - I||_F <= tol (err measured BEFORE
        each update, so the returned X carries ~err^2), at most max_iter
        updates."""

        def cond(c):
            _, err, k = c
            return (err > _SCHULZ_TOL) & (k < max_iter)

        def body(c):
            X, _, k = c
            P = M @ X
            err = jnp.linalg.norm(P - eye_n)
            X = X @ (2.0 * eye_n - P)
            X = 0.5 * (X + X.T)
            return X, err, k + 1

        return jax.lax.while_loop(cond, body, (X, err0, jnp.asarray(0)))

    def schulz_refresh(X, M):
        """Refresh X against the current M; on divergence (stale warm X or
        f32 overflow) reset to the scaled identity and re-bootstrap.
        Returns (X, err) with err <= _SCHULZ_USABLE iff the inverse is
        usable.

        Two-phase budget: the warm sweep gets WARM_MAX=8
        updates — a healthy carried inverse converges in 1-3, a stale one
        fails fast instead of burning the full 64 in vmap lockstep — and
        the second sweep either CONTINUES a slowly-contracting warm X or
        re-bootstraps from the scaled identity when the warm sweep
        diverged, with the full 64 budget.
        """
        inf0 = jnp.asarray(jnp.inf, dtype)
        X1, e1, _ = _schulz_sweep(X, M, inf0, _SCHULZ_WARM_MAX)
        bad = ~jnp.isfinite(e1) | (e1 > 1.0) | ~jnp.all(jnp.isfinite(X1))
        t = 1.0 / jnp.maximum(
            jnp.max(jnp.sum(jnp.abs(M), axis=1)), jnp.asarray(1e-30, dtype)
        )
        X2, e2, _ = _schulz_sweep(
            jnp.where(bad, t * eye_n, X1),
            M,
            jnp.where(bad, inf0, e1),
            _SCHULZ_MAX,
        )
        return X2, e2

    def kkt_factor(s, z, use_lu=use_lu):
        """Factor the condensed Newton system once per IPM iteration.

        chol: M = Q + G^T diag(z/s) G is SPD (Q PD, the barrier term PSD);
        with equality constraints, dy is eliminated through the SPD Schur
        complement S = A M^{-1} A^T.  lu: partial-pivot LU of M (or of the
        [M, A'; A, 0] saddle block) — last-digit robust at extreme barrier
        conditioning (see solve_qp docstring).  Either factorization is
        shared by the predictor and the corrector solve.
        """
        w = z / s
        M = Q + (G.T * w) @ G
        if use_lu:
            if l > 0:
                K = jnp.block([[M, A.T], [A, jnp.zeros((l, l), dtype=dtype)]])
            else:
                K = M
            return (jax.scipy.linalg.lu_factor(K), None, None)
        cf = cho_factor(M)
        if l > 0:
            minv_at = cho_solve(cf, A.T)  # n x l
            cs = cho_factor(A @ minv_at)
        else:
            minv_at = jnp.zeros((n, 0), dtype=dtype)
            cs = None
        return cf, minv_at, cs

    def kkt_solve(fact, s, z, rd, rp, re, rc, kind=None):
        """Back-substitute one rhs through the shared factorization:

        [Q + G^T W G,  A^T] [dx]   [-rd - G^T ((z*rp - rc)/s)]
        [A,            0  ] [dy] = [-re]
        with W = diag(z/s); recover ds, dz elementwise.
        """
        if kind is None:
            kind = "schulz" if use_schulz else ("lu" if use_lu else "chol")
        cf, minv_at, cs = fact
        rhs_x = -rd - G.T @ ((z * rp - rc) / s)
        if kind == "schulz":
            X, M = cf, minv_at
            dx = X @ rhs_x
            dx = dx + X @ (rhs_x - M @ dx)
            dx = dx + X @ (rhs_x - M @ dx)
            dy = jnp.zeros((0,), dtype=dtype)
        elif kind == "lu":
            if l > 0:
                sol = jax.scipy.linalg.lu_solve(
                    cf, jnp.concatenate([rhs_x, -re])
                )
                dx, dy = sol[:n], sol[n:]
            else:
                dx = jax.scipy.linalg.lu_solve(cf, rhs_x)
                dy = jnp.zeros((0,), dtype=dtype)
        elif l > 0:
            minv_rhs = cho_solve(cf, rhs_x)
            dy = cho_solve(cs, A @ minv_rhs + re)
            dx = minv_rhs - minv_at @ dy
        else:
            dx = cho_solve(cf, rhs_x)
            dy = jnp.zeros((0,), dtype=dtype)
        ds = -(rp + G @ dx)
        dz = -(rc + z * ds) / s
        return dx, ds, dz, dy

    def max_step(v, dv):
        """Largest alpha in (0, 1] keeping v + alpha dv > 0."""
        ratio = jnp.where(dv < 0, -v / jnp.where(dv < 0, dv, -1.0), jnp.inf)
        return jnp.minimum(1.0, 0.99 * jnp.min(ratio, initial=jnp.inf))

    class State(NamedTuple):
        x: jnp.ndarray
        s: jnp.ndarray
        z: jnp.ndarray
        y: jnp.ndarray
        k: jnp.ndarray
        done: jnp.ndarray
        stalled: jnp.ndarray  # NaN-frozen at the last finite iterate
        X: jnp.ndarray  # schulz: running inverse ((0,0) otherwise)
        Xf: jnp.ndarray  # schulz: first-iteration snapshot (next-QP warm)

    def converged(x, s, z, y):
        rd, rp, re = residuals(x, s, z, y)
        gap = jnp.vdot(s, z)
        pcost = 0.5 * x @ Q @ x + p @ x
        pr_inf = jnp.linalg.norm(jnp.concatenate([rp, re])) / jnp.maximum(
            1.0, jnp.linalg.norm(jnp.concatenate([h, b]))
        )
        du_inf = jnp.linalg.norm(rd) / jnp.maximum(1.0, jnp.linalg.norm(p))
        rel_ok = gap <= reltol * jnp.maximum(jnp.abs(pcost), 1.0)
        return (pr_inf <= feastol) & (du_inf <= feastol) & (
            (gap <= abstol) | rel_ok
        )

    def make_body(kind):
      def body(st):
        x, s, z, y = st.x, st.s, st.z, st.y
        rd, rp, re = residuals(x, s, z, y)
        mu = jnp.vdot(s, z) / max(m, 1)  # m == 0: equality-only QP, mu := 0
        if kind == "schulz":
            M = build_m(s, z)
            Xr, schulz_err = schulz_refresh(st.X, M)
            fact = (Xr, M, None)
        else:
            fact = kkt_factor(s, z, use_lu=kind == "lu")

        # affine (predictor) step
        rc_aff = z * s
        dx_a, ds_a, dz_a, dy_a = kkt_solve(fact, s, z, rd, rp, re, rc_aff,
                                           kind=kind)
        alpha_p = max_step(s, ds_a)
        alpha_d = max_step(z, dz_a)
        alpha_a = jnp.minimum(alpha_p, alpha_d)
        mu_aff = jnp.vdot(s + alpha_a * ds_a, z + alpha_a * dz_a) / max(m, 1)
        sigma = jnp.clip((mu_aff / jnp.maximum(mu, 1e-300)) ** 3, 0.0, 1.0)

        # corrector step (same factorization, new rhs)
        rc = z * s + ds_a * dz_a - sigma * mu
        dx, ds, dz, dy = kkt_solve(fact, s, z, rd, rp, re, rc, kind=kind)
        alpha = jnp.minimum(max_step(s, ds), max_step(z, dz))

        x_n = x + alpha * dx
        s_n = s + alpha * ds
        z_n = z + alpha * dz
        y_n = y + alpha * dy
        # NaN-freeze: in f32 the factorization of a rounding-indefinite
        # Newton matrix yields NaN steps; without this guard a poisoned
        # lane never satisfies converged() and burns the FULL maxiter in
        # lockstep with healthy lanes (seen in batched RSQO sweeps:
        # 400-iteration burns vs 4-8 for healthy lanes, every SQP step).
        # Freeze at the LAST FINITE iterate instead: status 2, the caller
        # gets a usable approximate solution.
        ok = (
            jnp.all(jnp.isfinite(x_n))
            & jnp.all(jnp.isfinite(s_n))
            & jnp.all(jnp.isfinite(z_n))
            & jnp.all(jnp.isfinite(y_n))
        )
        if kind == "schulz":
            # A Schulz refresh that exhausted its budget above the usable
            # threshold (even after the identity reset) means the
            # direction carries O(err^3) > few-% relative error: freeze
            # exactly like a NaN factorization would (the old
            # err <= 1 gate let a lane burn its remaining maxiter on
            # near-useless steps at extreme late-IPM conditioning).
            ok = ok & (schulz_err <= _SCHULZ_USABLE)
        keep = lambda new, old: jnp.where(ok, new, old)
        x, s, z, y = keep(x_n, x), keep(s_n, s), keep(z_n, z), keep(y_n, y)
        stalled = st.stalled | ~ok
        if kind == "schulz":
            X_new = jnp.where(ok, Xr, st.X)
            Xf_new = jnp.where((st.k == 0) & ok, X_new, st.Xf)
        else:
            X_new, Xf_new = st.X, st.Xf
        return State(
            x, s, z, y, st.k + 1, converged(x, s, z, y) | ~ok, stalled,
            X_new, Xf_new,
        )

      return body

    body = make_body(
        "schulz" if use_schulz else ("lu" if use_lu else "chol")
    )

    def cond(st):
        return (~st.done) & (st.k < maxiter)

    if use_schulz:
        # Warm X from the previous QP when the caller passed one with
        # content; otherwise the scaled identity (first refresh sweep in
        # body() pays the ~log2(cond) bootstrap).
        M0 = build_m(s0, z0)
        t0 = 1.0 / jnp.maximum(
            jnp.max(jnp.sum(jnp.abs(M0), axis=1)), jnp.asarray(1e-30, dtype)
        )
        cold = t0 * eye_n
        if xinv0 is None:
            X_init = cold
        else:
            xw = jnp.asarray(xinv0, dtype=dtype)
            X_init = jnp.where(
                jnp.all(jnp.isfinite(xw)) & (jnp.sum(xw * xw) > 0), xw, cold
            )
        Xf_init = jnp.zeros((n, n), dtype=dtype)
    else:
        X_init = jnp.zeros((0, 0), dtype=dtype)
        Xf_init = jnp.zeros((0, 0), dtype=dtype)

    st = jax.lax.while_loop(
        cond, body,
        State(
            x0, s0, z0, y0, jnp.asarray(0),
            converged(x0, s0, z0, y0), jnp.asarray(False),
            X_init, Xf_init,
        ),
    )
    if use_polish:
        # 'schulz_polish': the schulz loop floors at
        # O(err^3) ~ 1e-6-relative direction error — measured 3.3e-7 KKT
        # floor vs the 3.3e-15 deep-parity targets.  Polish with up to 3
        # EXACT partial-pivot-LU IPM iterations from the schulz endpoint:
        # near-schulz cost per QP (2-3 factorizations vs the 'lu' path's
        # 10-30), last-digit-accurate directions where it matters.  A
        # genuinely converged or NaN-frozen lane skips the polish via its
        # recomputed done flag.
        k_end = st.k
        # stalled lanes RESUME here: the schulz freeze (status 2) fires
        # exactly when the inverse degraded past usability — the LU
        # factorization has no such limit and continues from the frozen
        # (finite) iterate
        st = st._replace(
            done=converged(st.x, st.s, st.z, st.y),
            stalled=jnp.asarray(False),
        )
        polish_body = make_body("lu")

        def polish_cond(s2):
            return (~s2.done) & (s2.k < k_end + 3)

        st = jax.lax.while_loop(polish_cond, polish_body, st)
    rd, rp, re = residuals(st.x, st.s, st.z, st.y)
    return QpResult(
        x=st.x,
        z=st.z,
        y=st.y,
        s=st.s,
        iterations=st.k,
        gap=jnp.vdot(st.s, st.z),
        primal_infeasibility=jnp.linalg.norm(jnp.concatenate([rp, re])),
        dual_infeasibility=jnp.linalg.norm(rd),
        status=jnp.where(st.stalled, 2, jnp.where(st.done, 0, 1)),
        xinv=st.Xf if use_schulz else None,
    )
