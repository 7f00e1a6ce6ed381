"""RSQO: Riemannian Sequential Quadratic Optimization (Obara-Okuno-Takeda).

Parity target: ``/root/reference/src/solver/RSQO.py``:

* Lagrangian Hessian materialization + eigenvalue regularization
  (``reghess``, RSQO.py:114-134; ``reghess_operator`` :135-145; ``eye`` :146-149)
* linearized constraint matrices          RSQO.py:160-191
* tangent-space QP (CVXOPT there)         RSQO.py:196-208 -> ops/qp.py here
* ell_1-penalty backtracking line search  RSQO.py:229-247
* penalty update rho <- upsilon + tau     RSQO.py:220-227

Design: Hessian materialization is one batched vmap over the
deterministic basis; the constraint matrix G is one vmapped vjp; the QP is
our jittable Mehrotra IPM, so the whole step is a single XLA program.
"""

from __future__ import annotations

import copy
from typing import NamedTuple

import jax
import jax.numpy as jnp

from riptrm_tpu.ops.basis import constraint_grad_rows, materialize_symmetrized
from riptrm_tpu.ops.kkt import evaluation
from riptrm_tpu.ops.qp import solve_qp
from riptrm_tpu.solvers.base import (
    Output,
    host_run,
    max_abs_multiplier,
    maybe_wandb_finish,
    maybe_wandb_init,
    merge_options,
)


def default_option():
    """Defaults mirroring ``RSQO.py:26-65``."""
    return {
        "maxtime": 100,
        "maxiter": 100,
        "tolresid": 1e-6,
        "quadoptim_type": "reghess",  # 'reghess' or 'eye'
        "quadoptim_eigvalcorr": 1e-8,
        "quadoptim_eigvalthld": 1e-5,
        "quadoptim_maxiter": 400,
        "quadoptim_abstol": 1e-12,
        "quadoptim_reltol": 1e-12,
        "quadoptim_feastol": 1e-12,
        # Warm-start each QP's dual from the SQP iterate's multipliers
        # (fewer IPM iterations per QP).  False = reference-parity
        # cold start (CVXOPT cold-starts every QP, RSQO.py:196-208): the
        # warm start perturbs the approximate QP solution within its
        # tolerance, which over 10^4 SQP steps at 1e-15-deep residual
        # targets shifts which stationary point a StableIdentification
        # trajectory lands on (measured: 14/20 protocol targets cold vs
        # 0/20 warm) — deep-parity runs must cold-start.
        "quadoptim_warm_start": True,
        # 'chol' (fast condensed Cholesky) or 'lu' (last-digit robust at
        # extreme barrier conditioning) — see ops/qp.py::solve_qp.
        "quadoptim_linear_solver": "chol",
        "rho": 1.0,
        "tau": 0.5,
        "beta": 0.9,
        "gamma": 0.25,
        "linesearch_max": 10000,
        "linesearch_threshold": 1e-8,
        "verbosity": 0,
        "wandb_logging": False,
        "do_exit_on_error": True,
    }


class RsqoState(NamedTuple):
    x: object
    y: jnp.ndarray  # inequality multipliers
    z: jnp.ndarray  # equality multipliers
    rho: jnp.ndarray
    # quadoptim_linear_solver='schulz': the previous QP's first-iteration
    # Newton-Schulz inverse, warm-starting the next QP's X (None otherwise —
    # JAX treats None as an empty subtree, so the carry structure is static
    # per configuration).
    qp_xinv: object = None


def _shift_regularize(q, thld, corr):
    """PD regularization by certified diagonal shift (quadoptim_type
    ``reghess_shift``) — the batch-friendly alternative to the reference's
    eigenvalue clamp (``RSQO.py:126-131``).

    The clamp needs a full eigh every SQP step, the most expensive
    operation of a batched step.  Here: the extreme
    eigenvalues are estimated with one short dense Lanczos (k=12 matvecs —
    replaces the original 36 sequential power iterations at better
    accuracy; Ritz extremes converge geometrically where power iteration
    crawls on clustered spectra), the shift s = max(0, corr -
    lambda_min_est) is CERTIFIED by a Cholesky factorization check and
    escalated x4 until the factor is finite, so Q + sI is guaranteed PD
    even when the Ritz minimum overestimates lambda_min.  Whenever Q is
    already sufficiently PD (lambda_min >= thld — every late SQP step at a
    strict minimizer) the shift is ~0 and the regularized Q coincides with
    the reference clamp; on indefinite early steps both are (different)
    valid PD regularizations and the SQP converges to the same KKT point.
    """
    from riptrm_tpu.ops.spectrum import lanczos

    dim = q.shape[0]
    dt = q.dtype
    eye = jnp.eye(dim, dtype=dt)
    # deterministic start (no RNG in the solver path)
    v0 = jnp.ones((dim,), dtype=dt) + jnp.linspace(0.0, 1.0, dim, dtype=dt)
    v0 = v0 / jnp.linalg.norm(v0)

    k = min(12, dim)
    _, _, ritz = lanczos(lambda v: q @ v, v0, lambda u, w: u @ w, k)
    lam_min_est, rho_max = ritz[0], ritz[-1]
    s0 = jnp.maximum(
        0.0, corr - lam_min_est + 0.01 * jnp.abs(lam_min_est) + thld
    ).astype(dt)
    step = jnp.asarray(thld + 0.01 * jnp.abs(rho_max), dt)

    def cond(c):
        _, ok, k = c
        return (~ok) & (k < 6)

    def body(c):
        s_try, _, k = c
        cf, _ = jax.scipy.linalg.cho_factor(q + s_try * eye)
        ok = jnp.all(jnp.isfinite(cf))
        return (jnp.where(ok, s_try, 4.0 * s_try + step), ok, k + 1)

    s, _, _ = jax.lax.while_loop(
        cond, body, (s0, jnp.asarray(False), jnp.asarray(0))
    )
    return q + s * eye


def _ell1_penalty(problem, x, rho):
    """f + rho * (sum max(0, g) + sum |h|)  (``RSQO.py:11-21``)."""
    val = problem.cost(x)
    vio = jnp.asarray(0.0, dtype=val.dtype)
    if problem.has_ineq:
        vio = vio + jnp.sum(jnp.maximum(0.0, problem.ineq(x)))
    if problem.has_eq:
        vio = vio + jnp.sum(jnp.abs(problem.eq(x)))
    return val + rho * vio


def make_step(problem, option):
    man = problem.manifold
    dim = man.dim
    m = problem.num_ineq
    l = problem.num_eq
    thld = option["quadoptim_eigvalthld"]
    corr = option["quadoptim_eigvalcorr"]
    tau = option["tau"]
    beta = option["beta"]
    gamma = option["gamma"]
    tolresid = option["tolresid"]
    qp_abstol = max(option["quadoptim_abstol"], tolresid)
    qp_reltol = max(option["quadoptim_reltol"], tolresid)
    qp_feastol = max(option["quadoptim_feastol"], tolresid)

    # Structured closed-form fast path (sphere_quadratic: NonnegPCA).  The
    # Lagrangian Hessian's ambient form is -2 Zs with curvature
    # kappa = x'(-2 Zs x - y), so Q is ONE O(n^2) Householder congruence
    # instead of dim HVPs; the linearized constraint rows of g(x) = -x are
    # G = -B^T exactly (rgrad g_i = P(-e_i), coords = -B e_i) — both replace
    # O(n^3) batched-autodiff fan-outs (see ops/basis.py).
    structured_sphere = (
        problem.structure is not None
        and problem.structure.get("kind") == "sphere_quadratic"
        and problem.num_eq == 0
    )

    def _q_raw_structured(x, y):
        from riptrm_tpu.ops.basis import sphere_householder_congruence

        zs = problem.structure["Zs"].astype(y.dtype)
        kappa = x @ (-2.0 * (zs @ x) - y)
        return sphere_householder_congruence(x, -2.0 * zs, kappa)

    def step(state: RsqoState):
        x, y, z, rho = state.x, state.y, state.z, state.rho
        basis = man.basis(x)

        def q_raw_at(x, y, z):
            if structured_sphere:
                return _q_raw_structured(x, y)
            hess = problem.lag_rhess_at(x, y, z)  # primal trace frozen
            return materialize_symmetrized(man, x, basis, hess)

        # --- regularized Lagrangian Hessian in coordinates ---------------
        if option["quadoptim_type"] == "reghess":
            q_raw = q_raw_at(x, y, z)
            w, v = jnp.linalg.eigh(q_raw)
            w = jnp.where(w < thld, corr, w)
            q_mat = (v * w) @ v.T
            q_mat = 0.5 * (q_mat + q_mat.T)
        elif option["quadoptim_type"] == "reghess_operator":
            # Reference RSQO.py:135-145: clamp the operator spectrum and use
            # a diagonal Q in the operator's eigenbasis.  Equivalent here:
            # diagonalize the materialized Hessian and rotate all
            # coordinates into the eigenbasis, keeping Q diagonal.
            q_raw = q_raw_at(x, y, z)
            w, v = jnp.linalg.eigh(q_raw)
            w = jnp.where(w < thld, corr, w)
            q_mat = jnp.diag(w)
            coord_rot = v.T  # coords_new = V^T coords_old
        elif option["quadoptim_type"] == "reghess_shift":
            q_raw = q_raw_at(x, y, z)
            q_mat = _shift_regularize(q_raw, thld, corr)
        elif option["quadoptim_type"] == "eye":
            q_mat = jnp.eye(dim, dtype=y.dtype)
        else:
            raise ValueError(f"quadoptim_type {option['quadoptim_type']}")
        if option["quadoptim_type"] != "reghess_operator":
            coord_rot = None

        p_vec = man.to_coords(x, basis, problem.rgrad(x))

        # --- linearized constraints (one vmapped vjp per family) --------
        if structured_sphere:
            g_mat = -basis.T.astype(y.dtype)  # rows: coords of rgrad(-x)_i
            h_vec = -problem.ineq(x)
        elif m > 0:
            g_mat = constraint_grad_rows(man, x, basis, problem.ineq, m, dtype=y.dtype)
            h_vec = -problem.ineq(x)
        else:
            g_mat = jnp.zeros((0, dim), dtype=y.dtype)
            h_vec = jnp.zeros((0,), dtype=y.dtype)
        if l > 0:
            a_mat = constraint_grad_rows(man, x, basis, problem.eq, l, dtype=y.dtype)
            b_vec = -problem.eq(x)
        else:
            a_mat = jnp.zeros((0, dim), dtype=y.dtype)
            b_vec = jnp.zeros((0,), dtype=y.dtype)

        if coord_rot is not None:
            p_vec = coord_rot @ p_vec
            g_mat = g_mat @ coord_rot.T
            a_mat = a_mat @ coord_rot.T

        # --- tangent-space QP -------------------------------------------
        # Warm-started from the SQP iteration's own multipliers: near
        # convergence (x=0, s=h, z=y) is primal-feasible and near-
        # stationary, so the IPM needs only a few Cholesky iterations
        # (the reference cold-starts CVXOPT on every QP, RSQO.py:196-208).
        sol = solve_qp(
            q_mat, p_vec, g_mat, h_vec, a_mat, b_vec,
            abstol=qp_abstol, reltol=qp_reltol, feastol=qp_feastol,
            maxiter=option["quadoptim_maxiter"],
            warm_z=y if (m > 0 and option["quadoptim_warm_start"]) else None,
            method=option["quadoptim_linear_solver"],
            xinv0=state.qp_xinv,
        )
        coeff = sol.x
        y_new = sol.z
        z_new = sol.y

        df0 = coeff @ (q_mat @ coeff)
        coeff_basis = coeff if coord_rot is None else coord_rot.T @ coeff
        direction = man.from_coords(x, basis, coeff_basis)
        normdx = man.norm(x, direction)

        # --- penalty update (RSQO.py:220-227) ---------------------------
        upsilon = jnp.asarray(0.0, dtype=rho.dtype)
        if m > 0:
            upsilon = jnp.maximum(upsilon, jnp.max(y_new))
        if l > 0:
            upsilon = jnp.maximum(upsilon, jnp.max(jnp.abs(z_new)))
        rho = jnp.where(rho < upsilon, upsilon + tau, rho)

        # --- ell_1 penalty line search (RSQO.py:229-247) ----------------
        f0 = _ell1_penalty(problem, x, rho)
        gamma_df0 = gamma * df0

        def trial(stepsize):
            x_new = man.retract(x, jax.tree.map(lambda a: stepsize * a, direction))
            return x_new, _ell1_penalty(problem, x_new, rho)

        x1, f1 = trial(jnp.asarray(1.0, dtype=rho.dtype))

        def cond(carry):
            stepsize, gdf0, x_new, f_new, k = carry
            # NaN-robust Armijo: a non-finite trial value must KEEP
            # backtracking (the naive `f_new > bound` comparison is False
            # on NaN and would accept a poisoned point), expressed as
            # ~(f_new <= bound) | ~isfinite.
            bound = f0 - gdf0
            close = jnp.abs(f_new - bound) <= option["linesearch_threshold"]
            accept = (f_new <= bound) | close
            need = ~accept | ~jnp.isfinite(f_new)
            # stepsize underflow guard: a fully non-finite direction can
            # never produce a finite trial — stop once the step is gone
            return need & (k < option["linesearch_max"]) & (stepsize > 1e-20)

        def body(carry):
            stepsize, gdf0, _, _, k = carry
            stepsize = stepsize * beta
            gdf0 = gdf0 * beta
            x_new, f_new = trial(stepsize)
            return (stepsize, gdf0, x_new, f_new, k + 1)

        stepsize, _, x_new, f_new, ls_count = jax.lax.while_loop(
            cond, body, (jnp.asarray(1.0, dtype=rho.dtype), gamma_df0, x1, f1, jnp.asarray(0))
        )
        ls_status = ls_count < option["linesearch_max"]

        new_state = RsqoState(
            x=x_new, y=y_new, z=z_new, rho=rho, qp_xinv=sol.xinv
        )
        info = {
            "rho": rho,
            "upsilon": upsilon,
            "quadoptim_status": sol.status,
            "quadoptim_iter": sol.iterations,
            "quadoptim_gap": sol.gap,
            "quadoptim_primalinfeasibility": sol.primal_infeasibility,
            "quadoptim_dualinfeasibility": sol.dual_infeasibility,
            "normdx": normdx,
            "stepsize": stepsize,
            "df0": df0,
            "linesearch_status": ls_status,
            "linesearch_counter": ls_count,
        }
        return new_state, info

    return step


def init_state(problem, option):
    # All carried leaves are pinned to the problem's COORDINATE dtype
    # (the dtype of x0's leaves, which is what Q — and therefore every
    # solve_qp output — comes back in).  Deriving qp_xinv's dtype from y0
    # instead flipped the compiled while_loop carry dtype after the first
    # step on problems where y0's dtype differs from the coordinate dtype
    # (e.g. m == 0 under mixed precision).
    x_leaves = jax.tree.leaves(problem.x0)
    dtype = (
        jnp.result_type(*x_leaves) if x_leaves else jnp.asarray(1.0).dtype
    )
    # Refuse a LOSSY dual cast: f64 duals with f32
    # coordinates must not be silently truncated.  (Promoting instead
    # would desync the while_loop carry — the QP outputs follow the
    # coordinate dtype — so the mixed case is an error the caller fixes
    # by casting x0 or the duals explicitly.)
    for name, arr in (("y0", problem.y0), ("z0", problem.z0)):
        if arr.size and jnp.result_type(arr.dtype, dtype) != jnp.dtype(dtype):
            raise ValueError(
                f"RSQO: problem.{name} has dtype {arr.dtype} but the "
                f"coordinate dtype is {jnp.dtype(dtype)}; casting would "
                "silently truncate the duals — cast x0 or the duals "
                "explicitly"
            )
    y0 = jnp.asarray(problem.y0, dtype=dtype)
    z0 = jnp.asarray(problem.z0, dtype=dtype)
    # 'schulz' carries the QP's Newton-Schulz inverse across SQP steps;
    # an all-zero init means "cold" to solve_qp (which then bootstraps
    # from the scaled identity on the first QP).
    qp_xinv = (
        jnp.zeros((problem.manifold.dim, problem.manifold.dim), dtype=dtype)
        if option.get("quadoptim_linear_solver") in ("schulz", "schulz_polish")
        else None
    )
    return RsqoState(
        x=problem.x0, y=y0, z=z0,
        rho=jnp.asarray(option["rho"], dtype=dtype),
        qp_xinv=qp_xinv,
    )


def solve_compiled_best(problem, option, max_steps: int):
    """Compiled RSQO solve tracking min-KKT-residual-so-far (the protocol
    metric, seeded with the initial residual); stops early once
    ``best <= target``.  Returns solve(state, target) -> (state, steps,
    best).  The loop body is the shared ``compiled_best_while``;
    ``solve_compiled`` delegates with target = -inf."""
    from riptrm_tpu.ops.kkt import compute_residual
    from riptrm_tpu.solvers.base import compiled_best_while, merge_options

    option = merge_options(default_option(), option or {})
    step = make_step(problem, option)
    tolresid = option["tolresid"]
    maxiter = option["maxiter"]

    def residual(st):
        return compute_residual(problem, st.x, st.y, st.z)[0]

    def step1(st):
        new_st, _ = step(st)
        res = residual(new_st)
        return new_st, res, jnp.asarray(True), res <= tolresid

    def solve(state, target):
        st, k, _, best = compiled_best_while(
            step1, state, target, min(max_steps, maxiter), residual(state),
            stall_window=option.get("sweep_stall_window"),
        )
        return st, k, best

    return solve


def solve_compiled(problem, option, max_steps: int):
    """Fully-compiled RSQO solve for vmapped sweeps: solve(state) -> (state, steps)."""
    inner = solve_compiled_best(problem, option, max_steps)

    def solve(state):
        st, k, _ = inner(state, -jnp.inf)
        return st, k

    return solve


class RSQO:
    def __init__(self, option=None):
        self.option = merge_options(default_option(), option or {})
        self.name = (
            f"RSQO_{self.option['quadoptim_type']}_corr"
            f"{self.option['quadoptim_eigvalcorr']:.0e}"
        )

    def run(self, problem) -> Output:
        option = self.option
        maybe_wandb_init(option, self.name)
        state = init_state(problem, option)
        # AOT-compile before the clock starts (compile is excluded time).
        step = jax.jit(make_step(problem, option)).lower(state).compile()
        eval_fn = (
            jax.jit(lambda xp, st: evaluation(problem, xp, st.x, st.y, st.z))
            .lower(state.x, state)
            .compile()
        )

        def status_row(st, info):
            status = {
                "rho": st.rho,
                "maxabsLagmult": max_abs_multiplier(st.y, st.z),
            }
            for key in (
                "upsilon", "quadoptim_status", "quadoptim_iter", "quadoptim_gap",
                "quadoptim_primalinfeasibility", "quadoptim_dualinfeasibility",
                "normdx", "stepsize", "df0", "linesearch_status",
                "linesearch_counter",
            ):
                status[key] = info.get(key)
            return status

        state, log, stop_reason = host_run(
            name=self.name,
            option=option,
            state=state,
            step=step,
            evaluate=eval_fn,
            status_row=status_row,
            get_x=lambda st: st.x,
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
            ineqLagmult=state.y,
            eqLagmult=state.z,
            option=copy.deepcopy(opt_out),
            log=log,
        )
