"""RIPM: Riemannian primal-dual Interior Point Method (Lai-Yoshise baseline).

Parity target: ``/root/reference/src/solver/RIPM.py``:

* KKT vector field F(x,y,z,s)           RIPM.py:75-88
* condensed Newton system + recovery    RIPM.py:480-516
* dense RepresentMat / matrix-free CR   RIPM.py:238-340
* merit line search with centrality     RIPM.py:631-683
* sigma/rho/gamma updates               RIPM.py:680-683
* checkNTequation self-verification     RIPM.py:521-628

Design notes:
* The constraint-gradient matrix G (rows = coords of rgrad g_i) is one
  vmapped vjp; the saddle system is dense in metric-orthonormal
  coordinates and solved with a single ``linalg.solve``.
* ``checkNTequation`` builds the full covariant-derivative matrix from the
  same blocks; its non-symmetric eigenvalues (no batched accelerator kernel) go through
  ``pure_callback`` to the host, as this is an explicitly debug-only path.
"""

from __future__ import annotations

import copy
from typing import NamedTuple

import jax
import jax.numpy as jnp
import numpy as np

from riptrm_tpu.ops.basis import constraint_grad_rows, materialize_symmetrized
from riptrm_tpu.ops.conjres import conjugate_residual
from riptrm_tpu.ops.kkt import evaluation
from riptrm_tpu.solvers.base import (
    Output,
    host_run,
    max_abs_multiplier,
    maybe_wandb_finish,
    maybe_wandb_init,
    merge_options,
)


def default_option():
    """Defaults mirroring ``RIPM.py:137-177``."""
    return {
        "maxtime": 100,
        "maxiter": 100,
        "tolresid": 1e-6,
        "KrylovIterMethod": False,
        "KrylovTolrelresid": 1e-9,
        "KrylovMaxIteration": 1000,
        # Jacobi preconditioner for the condensed CR solve (extension; the
        # reference's TangentSpaceConjResMethod is unpreconditioned,
        # ``utils.py:582-619`` — but it never faced cond ~1e12 at f32:
        # near the boundary Theta = G^T diag(z/s) G has a z/s spread that
        # the d=32 StableIdentification barrier drives to ~1e12, flooring
        # unpreconditioned CR far above tolerance).  'jacobi_theta' runs
        # CR in metric-orthonormal basis coordinates with the exact
        # diagonal of Theta-hat plus a Rayleigh estimate of the Lagrangian
        # Hessian scale; requires a closed-form manifold basis and no
        # equality constraints.
        "KrylovPreconditioner": "none",  # or "jacobi_theta"
        # Compiled sweeps only: return the best-residual iterate instead of
        # the last (RIPM at an f32 conditioning floor churns around the
        # dip like RALM/staged-RIPTRM; the host .run() path is unaffected)
        "keep_best_point": False,
        "checkNTequation": False,
        "gamma": 0.9,
        "linesearch_execute_fun2": False,
        "linesearch_beta": 1e-4,
        "linesearch_theta": 0.5,
        "linesearch_max_steps": 50,
        "heuristic_z_s": False,
        "desired_tau_1": 0.5,
        "important": 1.0,
        "verbosity": 0,
        "wandb_logging": False,
        "do_exit_on_error": True,
    }


class RipmState(NamedTuple):
    x: object
    y: jnp.ndarray  # equality multipliers
    z: jnp.ndarray  # inequality multipliers
    s: jnp.ndarray  # slacks
    phi: jnp.ndarray
    sigma: jnp.ndarray
    rho: jnp.ndarray
    gamma: jnp.ndarray
    iteration: jnp.ndarray


def _kkt_field(problem, x, y, z, s):
    """F(w) = (grad_x L, h(x), g(x) + s, z * s) (``RIPM.py:75-88``)."""
    fx = problem.lag_rgrad(x, z, y)
    fy = problem.eq_val(x)
    fz = problem.ineq_val(x) + s
    fs = z * s
    return fx, fy, fz, fs


def _phi(problem, x, fx, fy, fz, fs):
    return (
        problem.manifold.inner(x, fx, fx)
        + jnp.vdot(fy, fy)
        + jnp.vdot(fz, fz)
        + jnp.vdot(fs, fs)
    )


def _gx_pos(problem, x, v):
    """Sum_i v_i * rgrad g_i (RIPM's barGx uses +grad g, ``RIPM.py:33-38``).
    Delegates to ``problem.gx`` (sign-flipped: gx works on the slack c = -g)
    so embedded problems differentiate in ambient space."""
    return problem.gx(x, -v)


def _gxaj_pos(problem, x, dx):
    return -problem.gx_adj(x, dx)


def _constraint_grad_matrix(problem, x, basis, m):
    """G with G[i, :] = coords of rgrad g_i — one vmapped vjp."""
    man = problem.manifold
    # seed dtype must match the ineq output's (the vjp rejects a mismatch;
    # under x64 a bare jnp.eye would be f64 against an f32 problem)
    dt = jax.tree.leaves(x)[0].dtype
    eye = jnp.eye(m, dtype=dt)
    return jax.vmap(lambda e: man.to_coords(x, basis, _gx_pos(problem, x, e)))(eye)


def _eq_grad_matrix(problem, x, basis, l):
    return constraint_grad_rows(problem.manifold, x, basis, problem.eq, l)


def make_step(problem, option):
    man = problem.manifold
    dim = man.dim
    m = problem.num_ineq
    l = problem.num_eq
    krylov = option["KrylovIterMethod"]
    check_nt = option["checkNTequation"]
    ls_beta = option["linesearch_beta"]
    ls_theta = option["linesearch_theta"]
    ls_max = option["linesearch_max_steps"]
    ls_fun2 = option["linesearch_execute_fun2"]

    def hess_lag(x, y, z, dx):
        return problem.lag_rhess(x, z, dx, y)

    def step(state: RipmState, tau_1, tau_2):
        x, y, z, s = state.x, state.y, state.z, state.s
        sigma, rho, gamma = state.sigma, state.rho, state.gamma
        fx, fy, fz, fs = _kkt_field(problem, x, y, z, s)
        phi_cur = _phi(problem, x, fx, fy, fz, fs)
        ehat = jnp.ones((m,), dtype=z.dtype)

        # Point-frozen operators: primal traces computed once per step.
        lag_hvp = problem.lag_rhess_at(x, z, y)
        gxaj_lin = problem.gx_adj_at(x)
        gx_neg = problem.gx_at(x)
        gx_pos = lambda v: gx_neg(-v)  # RIPM's barGx uses +grad g
        gxaj_pos = lambda dx: -gxaj_lin(dx)

        # Condensed Newton rhs (RIPM.py:480-482)
        c = jax.tree.map(
            lambda a, b: -a - b,
            fx,
            gx_pos((z * fz + sigma * rho * ehat - fs) / s),
        )
        q = -fy

        def op_aw(dx):
            theta = gx_pos(gxaj_pos(dx) * (z / s))
            return jax.tree.map(lambda a, b: a + b, lag_hvp(dx), theta)

        # Basis exists on manifolds with a closed-form dense basis; the
        # plain Krylov path (the only one FixedRankEmbedded supports) never
        # needs it, but the Jacobi-preconditioned CR runs in basis coords.
        precon = krylov and option.get("KrylovPreconditioner") == "jacobi_theta"
        basis = man.basis(x) if (not krylov or check_nt or precon) else None
        krylov_iters = jnp.asarray(0)
        krylov_relres = jnp.asarray(0.0, dtype=s.dtype)
        if precon:
            if l > 0:
                raise NotImplementedError(
                    "KrylovPreconditioner='jacobi_theta' supports "
                    "inequality-only problems (the equality block would "
                    "make the coordinate system indefinite-saddle)"
                )
            # CR on the symmetrically Jacobi-scaled operator in
            # metric-orthonormal coordinates: A-hat = D^-1/2 Ahat D^-1/2
            # with D = diag(Theta-hat) + Hessian Rayleigh scale.  The
            # exact Theta-hat diagonal is sum_k (z_k/s_k) G[k, i]^2 from
            # the constraint-gradient matrix (one vmapped vjp); the
            # ambient diagonal would NOT be metric-self-adjoint (SPD
            # carries the affine-invariant metric), the coordinate
            # diagonal is.
            g_mat = _constraint_grad_matrix(problem, x, basis, m)  # [m, dim]
            theta_diag = (z / s) @ (g_mat * g_mat)
            c_hat = man.to_coords(x, basis, c)
            hess_c = lag_hvp(c)
            cc = man.inner(x, c, c)
            rayleigh = jnp.abs(man.inner(x, c, hess_c)) / jnp.maximum(
                cc, jnp.finfo(s.dtype).tiny
            )
            d_raw = theta_diag + jnp.maximum(rayleigh, 1e-8)
            # Cap the preconditioner's own condition number: Theta-hat is
            # exactly ZERO along coordinates no constraint touches, so
            # d_raw's spread can reach ~1e14 when the Rayleigh scalar
            # underestimates the Hessian there — measured to destabilize
            # a lane (d=8 A/B).  The cap keeps the strong directions
            # scaled while bounding the amplification of weak ones.
            kappa_cap = option.get("KrylovPreconKappaCap", 1e8)
            d_scale = jnp.maximum(d_raw, jnp.max(d_raw) / kappa_cap)
            d_isqrt = jax.lax.rsqrt(d_scale)

            def op_hat(u):
                v = man.from_coords(x, basis, d_isqrt * u)
                return d_isqrt * man.to_coords(x, basis, op_aw(v))

            d_sqrt = jnp.sqrt(d_scale)

            sol, krylov_iters, krylov_relres = conjugate_residual(
                lambda u, v: jnp.vdot(u, v),
                op_hat,
                d_isqrt * c_hat,
                jnp.zeros((dim,), dtype=s.dtype),
                tol=option["KrylovTolrelresid"],
                maxiter=option["KrylovMaxIteration"],
                # stop on the ORIGINAL-system residual norm so the inexact
                # Newton direction quality matches the plain CR's tol
                stop_norm=lambda r: jnp.linalg.norm(d_sqrt * r),
            )
            ntdir_x = man.from_coords(x, basis, d_isqrt * sol)
            ntdir_y = jnp.zeros((0,), dtype=s.dtype)
        elif krylov:
            # Matrix-free conjugate residual on T_x M x R^l (RIPM.py:304-340)
            def op_t(dxdy):
                dx, dy = dxdy
                out_x = op_aw(dx)
                if l > 0:
                    out_x = jax.tree.map(
                        lambda a, b: a + b, out_x, problem.hx(x, dy)
                    )
                    out_y = problem.hx_adj(x, dx)
                else:
                    out_y = jnp.zeros((0,), dtype=s.dtype)
                return (out_x, out_y)

            inner = lambda u, v: man.inner(x, u[0], v[0]) + jnp.vdot(u[1], v[1])
            v0 = (man.zero_vector(x), jnp.zeros((l,), dtype=s.dtype))
            (ntdir_x, ntdir_y), krylov_iters, krylov_relres = conjugate_residual(
                inner,
                op_t,
                (c, q),
                v0,
                tol=option["KrylovTolrelresid"],
                maxiter=option["KrylovMaxIteration"],
            )
        else:
            # Dense saddle solve in coordinates (RIPM.py:238-302)
            aw_mat = materialize_symmetrized(man, x, basis, op_aw)
            c_vec = man.to_coords(x, basis, c)
            if l > 0:
                heq = _eq_grad_matrix(problem, x, basis, l)  # [l, dim]
                t_mat = jnp.block(
                    [[aw_mat, heq.T], [heq, jnp.zeros((l, l), dtype=s.dtype)]]
                )
                rhs = jnp.concatenate([c_vec, q])
                sol = jnp.linalg.solve(t_mat, rhs)
                ntdir_x = man.from_coords(x, basis, sol[:dim])
                ntdir_y = sol[dim:]
            else:
                sol = jnp.linalg.solve(aw_mat, c_vec)
                ntdir_x = man.from_coords(x, basis, sol)
                ntdir_y = jnp.zeros((0,), dtype=s.dtype)

        # Recover dz, ds (RIPM.py:514-516)
        gxaj_dx = gxaj_pos(ntdir_x)
        ntdir_z = (z * (gxaj_dx + fz) + sigma * rho * ehat - fs) / s
        ntdir_s = (sigma * rho * ehat - fs - s * ntdir_z) / z

        norm_ntdir_x = man.norm(x, ntdir_x)
        norm_ntdir_w = jnp.sqrt(
            norm_ntdir_x**2
            + jnp.vdot(ntdir_y, ntdir_y)
            + jnp.vdot(ntdir_z, ntdir_z)
            + jnp.vdot(ntdir_s, ntdir_s)
        )
        grad_f = problem.rgrad(x)
        gradf_ntdir = man.inner(x, grad_f, ntdir_x)

        # Optional debug self-check (RIPM.py:521-628)
        nt_info = {}
        if check_nt:
            nt_info = _check_nt_equation(
                problem, x, y, z, s, basis,
                (ntdir_x, ntdir_y, ntdir_z, ntdir_s),
                (fx, fy, fz, fs), phi_cur, sigma, rho, op_aw, hess_lag,
            )

        # Backtracking merit line search with centrality (RIPM.py:631-663)
        ls_right = 2.0 * (sigma * rho * jnp.vdot(z, s) - phi_cur)

        def trial(stepsize):
            x_new = man.retract(x, jax.tree.map(lambda a: stepsize * a, ntdir_x))
            y_new = y + stepsize * ntdir_y
            z_new = z + stepsize * ntdir_z
            s_new = s + stepsize * ntdir_s
            f = _kkt_field(problem, x_new, y_new, z_new, s_new)
            phi_new = _phi(problem, x_new, *f)
            return (x_new, y_new, z_new, s_new), f, phi_new

        def ls_ok(stepsize, z_new, s_new, phi_new):
            armijo = phi_new - phi_cur <= ls_beta * stepsize * ls_right
            zs = z_new * s_new
            fun1 = jnp.min(zs) - gamma * tau_1 * (jnp.vdot(z_new, s_new) / m) >= 0
            ok = armijo & fun1
            if ls_fun2:
                fun2 = (
                    jnp.vdot(z_new, s_new)
                    - gamma * tau_2 * jnp.sqrt(phi_new)
                ) >= 0
                ok = ok & fun2
            return ok

        w1, f1, phi1 = trial(jnp.asarray(1.0, dtype=s.dtype))

        def cond(carry):
            stepsize, w, f, phi_new, r, ok = carry
            return (~ok) & (r <= ls_max)

        def body(carry):
            stepsize, w, f, phi_new, r, ok = carry
            new_stepsize = stepsize * ls_theta
            w2, f2, phi2 = trial(new_stepsize)
            ok2 = ls_ok(new_stepsize, w2[2], w2[3], phi2)
            new = (new_stepsize, w2, f2, phi2, r + 1, ok2)
            # Explicit freeze of a lane whose line search already
            # succeeded.  NOTE: JAX's while_loop BATCHING RULE already
            # masks body outputs per-lane (measured round 5: adding this
            # freeze changed no vmapped result bit-for-bit), so this is
            # defensive documentation of the required semantics, not a
            # behavior change — it also keeps the loop correct under
            # lockstep execution contexts without that rule (e.g. a
            # future shard_map/pallas port of the step).
            return jax.tree.map(
                lambda n, o: jnp.where(ok, o, n), new, carry
            )

        ok1 = ls_ok(jnp.asarray(1.0, dtype=s.dtype), w1[2], w1[3], phi1)
        stepsize, w_new, f_new, phi_new, r, ok = jax.lax.while_loop(
            cond, body, (jnp.asarray(1.0, dtype=s.dtype), w1, f1, phi1, jnp.asarray(0), ok1)
        )
        ls_status = r <= ls_max

        x_new, y_new, z_new, s_new = w_new
        sigma_new = jnp.minimum(0.5, phi_new**0.25)
        rho_new = jnp.vdot(z_new, s_new) / m
        gamma_new = 0.5 * (gamma + 0.5)

        # Singular-Newton guard: on (near-)singular T the XLA solve does
        # not raise — it yields NaN/Inf, which would poison x and silently
        # burn the whole budget.  The reference exits its loop on the
        # LinAlgError with logs preserved (``RIPM.py:764-769``); here the
        # state is FROZEN and ``singular_newton`` is flagged so the host
        # runner stops gracefully and compiled sweeps freeze the lane.
        dir_finite = jnp.isfinite(norm_ntdir_w) & jnp.isfinite(phi_new)

        def keep(new, old):
            return jax.tree.map(lambda a, b: jnp.where(dir_finite, a, b), new, old)

        new_state = RipmState(
            x=keep(x_new, x), y=keep(y_new, state.y), z=keep(z_new, z),
            s=keep(s_new, s),
            phi=keep(phi_new, phi_cur), sigma=keep(sigma_new, sigma),
            rho=keep(rho_new, rho), gamma=keep(gamma_new, gamma),
            iteration=state.iteration + 1,
        )
        info = {
            "normNTdirx": norm_ntdir_x,
            "normNTdirw": norm_ntdir_w,
            "stepsize": stepsize,
            "linesearch_status": ls_status,
            "linesearch_counter": r,
            "linesearch_RightItem": ls_right,
            "gradfNTdir": gradf_ntdir,
            "singular_newton": ~dir_finite,
        }
        if krylov:
            info["KrylovIterMethod_Iter"] = krylov_iters
            info["KrylovIterMethod_RelRes"] = krylov_relres
        info.update(nt_info)
        return new_state, info

    return step


def _check_nt_equation(
    problem, x, y, z, s, basis, ntdir, f, phi_cur, sigma, rho, op_aw, hess_lag
):
    """Debug-only Newton-system verification (``RIPM.py:521-628``):
    residual of the non-condensed system, merit-gradient identity, norm,
    angle, and min-|eigval| of the full covariant-derivative matrix."""
    man = problem.manifold
    dim = man.dim
    m = problem.num_ineq
    l = problem.num_eq
    ntdir_x, ntdir_y, ntdir_z, ntdir_s = ntdir
    fx, fy, fz, fs = f
    ehat = jnp.ones((m,), dtype=s.dtype)

    def nabla_f(dw):
        dx, dy, dz, ds = dw
        out_x = jax.tree.map(
            lambda a, b: a + b, hess_lag(x, y, z, dx), _gx_pos(problem, x, dz)
        )
        if l > 0:
            out_x = jax.tree.map(lambda a, b: a + b, out_x, problem.hx(x, dy))
            out_y = problem.hx_adj(x, dx)
        else:
            out_y = jnp.zeros((0,), dtype=s.dtype)
        out_z = _gxaj_pos(problem, x, dx) + ds
        out_s = z * ds + s * dz
        return out_x, out_y, out_z, out_s

    def nabla_f_adj(dw):
        dx, dy, dz, ds = dw
        out_x = jax.tree.map(
            lambda a, b: a + b, hess_lag(x, y, z, dx), _gx_pos(problem, x, dz)
        )
        if l > 0:
            out_x = jax.tree.map(lambda a, b: a + b, out_x, problem.hx(x, dy))
            out_y = problem.hx_adj(x, dx)
        else:
            out_y = jnp.zeros((0,), dtype=s.dtype)
        out_z = _gxaj_pos(problem, x, dx) + s * ds
        out_s = z * ds + dz
        return out_x, out_y, out_z, out_s

    def w_inner(u, v):
        return (
            man.inner(x, u[0], v[0])
            + jnp.vdot(u[1], v[1])
            + jnp.vdot(u[2], v[2])
            + jnp.vdot(u[3], v[3])
        )

    def w_norm(u):
        return jnp.sqrt(w_inner(u, u))

    # Item 1: residual of the non-condensed Newton equation
    rhs = (
        jax.tree.map(lambda a: -a, fx),
        -fy,
        -fz,
        -fs + sigma * rho * ehat,
    )
    lhs = nabla_f(ntdir)
    diff = jax.tree.map(lambda a, b: a - b, lhs, rhs)
    err1 = w_norm(diff)

    # Item 2: merit-gradient identity
    gradphi = jax.tree.map(lambda a: 2.0 * a, nabla_f_adj((fx, fy, fz, fs)))
    val = w_inner(gradphi, ntdir)
    err2 = jnp.abs(val - 2.0 * (sigma * rho * jnp.vdot(z, s) - phi_cur))
    norm_gradphi = w_norm(gradphi)
    ntdir_norm = w_norm(ntdir)
    angle = -val / (norm_gradphi * ntdir_norm)

    # min |eigval| of the covariant-derivative matrix: dense blocks in
    # coordinates, non-symmetric eig via host callback (debug only).
    h_mat = materialize_symmetrized(man, x, basis, lambda dx: hess_lag(x, y, z, dx))
    g_mat = _constraint_grad_matrix(problem, x, basis, m)  # [m, dim]
    if l > 0:
        heq = _eq_grad_matrix(problem, x, basis, l)
    else:
        heq = jnp.zeros((0, dim), dtype=s.dtype)
    zdim = dim + l + 2 * m
    zero = lambda r, c: jnp.zeros((r, c), dtype=s.dtype)
    full = jnp.block(
        [
            [h_mat, heq.T, g_mat.T, zero(dim, m)],
            [heq, zero(l, l), zero(l, m), zero(l, m)],
            [g_mat, zero(m, l), zero(m, m), jnp.eye(m, dtype=s.dtype)],
            [zero(m, dim), zero(m, l), jnp.diag(s), jnp.diag(z)],
        ]
    )

    def host_min_abs_eig(a):
        w = np.linalg.eigvals(np.asarray(a))
        return np.asarray(w[np.argmin(np.abs(w))].real, dtype=a.dtype)

    mineig = jax.pure_callback(
        host_min_abs_eig, jax.ShapeDtypeStruct((), s.dtype), full
    )
    return {
        "NTdir_error1": err1,
        "NTdir_error2": err2,
        "NTdir_norm": ntdir_norm,
        "NTdir_angle": angle,
        "CovDerivKKT_minabseigval": mineig,
    }


def init_state(problem, option):
    """``preprocess`` (``RIPM.py:342-444``)."""
    m = problem.num_ineq
    y0 = jnp.asarray(problem.z0)  # equality multipliers
    if option["heuristic_z_s"]:
        z0 = jnp.ones((m,))
        z0 = z0.at[0].set(
            jnp.sqrt((m - 1) / (m / option["desired_tau_1"] - 1))
        )
        s0 = option["important"] * z0
    else:
        z0 = jnp.asarray(problem.y0)
        s0 = jnp.asarray(problem.y0)
    x0 = problem.x0
    f = _kkt_field(problem, x0, y0, z0, s0)
    phi0 = _phi(problem, x0, *f)
    sigma0 = jnp.minimum(0.5, phi0**0.25)
    rho0 = jnp.vdot(z0, s0) / m
    tau_1 = jnp.min(z0 * s0) * m / jnp.vdot(z0, s0)
    tau_2 = jnp.vdot(z0, s0) / jnp.sqrt(phi0)
    state = RipmState(
        x=x0, y=y0, z=z0, s=s0, phi=phi0,
        sigma=sigma0, rho=rho0,
        gamma=jnp.asarray(option["gamma"], dtype=z0.dtype),
        iteration=jnp.asarray(0),
    )
    return state, tau_1, tau_2


def solve_compiled_best(problem, option, max_steps: int):
    """Compiled RIPM solve tracking min-KKT-residual-so-far (the protocol
    metric, seeded with the initial residual); stops early once
    ``best <= target``.  Returns solve(state, tau_1, tau_2, target) ->
    (state, steps, best).  The loop body is the shared
    ``compiled_best_while``; ``solve_compiled`` delegates with
    target = -inf."""
    from riptrm_tpu.ops.kkt import compute_residual
    from riptrm_tpu.solvers.base import compiled_best_while, merge_options

    option = merge_options(default_option(), option or {})
    step = make_step(problem, option)
    tolresid = option["tolresid"]
    maxiter = option["maxiter"]

    def residual(st):
        return compute_residual(problem, st.x, st.z, st.y)[0]

    def solve(state, tau_1, tau_2, target):
        def step1(st):
            new_st, info = step(st, tau_1, tau_2)
            res = residual(new_st)
            # singular_newton freezes the lane: the state no longer moves,
            # so further steps only burn budget
            stop = (
                (res <= tolresid)
                | (new_st.iteration >= maxiter)
                | info["singular_newton"]
            )
            return new_st, res, jnp.asarray(True), stop

        st, k, _, best = compiled_best_while(
            step1, state, target, max_steps, residual(state),
            stall_window=option.get("sweep_stall_window"),
            track_best_state=option.get("keep_best_point", False),
        )
        return st, k, best

    return solve


def solve_compiled(problem, option, max_steps: int):
    """Fully-compiled RIPM solve (lax.while_loop) for vmapped sweeps.

    Returns solve(state, tau_1, tau_2) -> (state, steps).
    """
    inner = solve_compiled_best(problem, option, max_steps)

    def solve(state, tau_1, tau_2):
        st, k, _ = inner(state, tau_1, tau_2, -jnp.inf)
        return st, k

    return solve


class RIPM:
    def __init__(self, option=None):
        self.option = merge_options(default_option(), option or {})
        kind = "Krylov" if self.option["KrylovIterMethod"] else "RepMat"
        self.name = (
            f"RIPM_{kind}_gamma{self.option['gamma']}_beta"
            f"{self.option['linesearch_beta']}_theta{self.option['linesearch_theta']}"
        )

    def run(self, problem) -> Output:
        option = self.option
        maybe_wandb_init(option, self.name)
        step_fn = make_step(problem, option)
        state, tau_1, tau_2 = init_state(problem, option)
        # AOT-compile before the clock starts (compile is excluded time).
        step_c = (
            jax.jit(lambda st, t1, t2: step_fn(st, t1, t2))
            .lower(state, tau_1, tau_2)
            .compile()
        )
        eval_fn = (
            jax.jit(lambda xp, st: evaluation(problem, xp, st.x, st.z, st.y))
            .lower(state.x, state)
            .compile()
        )

        def status_row(st, info):
            status = {
                "Phi": st.phi,
                "sigma": st.sigma,
                "rho": st.rho,
                "maxabsLagmult": max_abs_multiplier(st.z, st.y),
            }
            for key in (
                "normNTdirx", "normNTdirw", "stepsize", "linesearch_status",
                "linesearch_counter", "linesearch_RightItem", "gradfNTdir",
                "singular_newton",
                "KrylovIterMethod_Iter", "KrylovIterMethod_RelRes",
                "NTdir_error1", "NTdir_error2", "NTdir_norm", "NTdir_angle",
                "CovDerivKKT_minabseigval",
            ):
                if key in info:
                    status[key] = info[key]
                elif (
                    key.startswith("NTdir") or key.startswith("CovDeriv")
                ) and option["checkNTequation"]:
                    status[key] = None
                elif key.startswith("Krylov") and option["KrylovIterMethod"]:
                    status[key] = None
                elif not key.startswith(("Krylov", "NTdir", "CovDeriv")):
                    status[key] = info.get(key)
            return status

        state, log, stop_reason = host_run(
            name=self.name,
            option=option,
            state=state,
            step=lambda st: step_c(st, tau_1, tau_2),
            evaluate=eval_fn,
            status_row=status_row,
            get_x=lambda st: st.x,
            stop_flag=lambda st, info: (
                "Singular Newton system: the condensed saddle solve "
                "returned a non-finite direction; exiting with logs "
                "preserved (reference RIPM.py:764-769 semantics)"
                if bool(info.get("singular_newton", False))
                else None
            ),
            verbosity_line=lambda i, ev: (
                f"Iter: {i}, Cost: {float(ev['cost'])}, KKT residual: {float(ev['residual'])}"
            ),
        )

        self.option["stoppingcriterion"] = stop_reason
        maybe_wandb_finish(option)
        opt_out = {k: v for k, v in self.option.items() if not callable(v)}
        return Output(
            name=self.name,
            x=state.x,
            ineqLagmult=state.z,
            eqLagmult=state.y,
            option=copy.deepcopy(opt_out),
            log=log,
        )
