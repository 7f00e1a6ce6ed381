"""RIPTRM: Riemannian primal-dual Interior Point Trust-Region Method.

Accelerator-native re-design of the paper's solver
(``/root/reference/src/solver/RIPTRM.py``, arXiv:2501.15419).  Algorithmic
parity targets (file:line into /root/reference):

* barrier-KKT operator assembly   RIPTRM.py:707-745
* tCG / exact TRS direction       RIPTRM.py:426-455 (tCG: :41-216, gep TRS: :218-299)
* inner stopping criteria         RIPTRM.py:574-629
* ared/pred TR + dual clipping    RIPTRM.py:631-705
* inner budget reset semantics    RIPTRM.py:785-847
* outer barrier schedule          RIPTRM.py:866-896

Design decisions:
* The inner x outer loop nest is flattened into ONE pure ``step``: an inner
  trust-region iteration whose "converged" branch also applies the outer
  barrier-parameter update.  The same step powers (a) a host-driven runner
  with the reference's wall-clock protocol and (b) a fully-compiled
  ``lax.while_loop`` solve that can be ``vmap``-ed over initial points.
* All constraint work is stacked: the condensed barrier Hessian
  Hw(dx) = Hess_x L[dx] + Gx(y * Gxaj(dx) / c) costs one jvp-of-grad plus
  one jvp and one vjp of the stacked constraint function, independent of m.
* Exact mode materializes Hw with one batched vmap over the deterministic
  tangent basis and solves the TRS by symmetric eigendecomposition
  (``ops/trs.py``) instead of a 2n x 2n generalized nonsymmetric
  eigenproblem; the symmetric form is far cheaper and batches under vmap.
* Branching (converged / infeasible / accept / reject) is data-dependent and
  expressed with ``lax.cond``/``jnp.where`` so the whole step is one XLA
  program.
"""

from __future__ import annotations

import copy
import os
import time
from typing import NamedTuple

import jax
import jax.numpy as jnp

from riptrm_tpu.ops.basis import materialize_symmetrized
from riptrm_tpu.ops.kkt import evaluation
from riptrm_tpu.ops.tcg import truncated_cg
from riptrm_tpu.ops.trs import solve_trs_eig
from riptrm_tpu.solvers.base import (
    LogAccumulator,
    Output,
    WallClock,
    maybe_wandb_finish,
    maybe_wandb_init,
    maybe_wandb_log,
    merge_options,
)

# inner_status codes
INNER_INITIAL = 0
INNER_CONVERGED = 1
INNER_SUCCESSFUL = 2
INNER_UNSUCCESSFUL = 3
INNER_PRIMAL_INFEASIBLE = 4
INNER_MAX_TIME = 5
INNER_MAX_ITER = 6

INNER_STATUS_NAMES = {
    INNER_INITIAL: "initial",
    INNER_CONVERGED: "converged",
    INNER_SUCCESSFUL: "successful",
    INNER_UNSUCCESSFUL: "unsuccessful",
    INNER_PRIMAL_INFEASIBLE: "primal_infeasible",
    INNER_MAX_TIME: "max-time-exceeded",
    INNER_MAX_ITER: "max-iter-exceeded",
}

RADIUS_NAMES = {-1: None, 0: "unchanged", 1: "reduced", 2: "expanded"}
TCG_NAMES = {
    0: "tCG_MAX_INNER_ITER",
    1: "tCG_NEGATIVE_CURVATURE",
    2: "tCG_EXCEEDED_TR",
    3: "tCG_MODEL_INCREASED",
    4: "tCG_REACHED_TARGET_LINEAR",
    5: "tCG_REACHED_TARGET_SUPERLINEAR",
}
TRS_NAMES = {0: "interior", 1: "boundary", 2: "hardcase"}


def default_option():
    """Defaults mirroring ``RIPTRM.py:305-358``."""
    return {
        "maxtime": 240,
        "maxiter": 100,
        "tolresid": 1e-15,
        "inner_maxiter": None,
        "inner_maxtime": None,
        "initial_TR_radius": None,
        "minimal_initial_TR_radius": 1e-15,
        "maximal_TR_radius": 10.0,
        "rho": 0.1,
        "reduction_regularization": 1e3,
        "gamma": 0.25,
        "forcing_function_Lagrangian": lambda mu: jnp.maximum(mu, 1e-14),
        "forcing_function_complementarity": lambda mu: jnp.maximum(1e-3 * mu, 1e-14),
        "forcing_function_second_order": lambda mu: mu,
        "min_barrier_parameter": 1e-15,
        "TRS_solver": "Exact_RepMat",  # or 'tCG'
        # Exact-mode TRS algorithm: 'eigh' (dense eigendecomposition — the
        # reference-faithful route), 'ms' (safeguarded More-Sorensen by
        # Cholesky + dense-Lanczos extremes: one Cholesky per Newton step
        # instead of a full eigendecomposition), or 'auto' (ms at
        # dim >= 256, where eigh dominates the step, eigh below).
        "exact_trs_method": "auto",
        "second_order_stationarity": True,
        # tCG mode checks the second-order criterion matrix-free: Lanczos
        # Ritz extremes of Hw (this many HVPs), run only when the
        # first-order inner criteria already hold.  (The reference ties the
        # second-order check to the dense Exact_RepMat path; the matrix-free
        # form also serves manifolds with no closed-form basis, e.g.
        # FixedRankEmbedded.)
        "second_order_lanczos_iters": 64,
        "tCG_theta": 1.0,
        "tCG_kappa": 0.1,
        "tCG_mininner": 1,
        "initial_barrier_parameter": 0.1,
        "barrier_parameter_update_r": 0.01,
        "barrier_parameter_update_c": 0.5,
        "barrier_parameter_update_b": 0.8,
        "do_simple_barrier_parameter_update": True,
        "const_left": 0.5,
        "const_right": 1e20,
        "checkTRSoptimality": False,
        # Compensated (double-word f32) forms of the two scalar reductions
        # that set the batched-lane stall floor: the complementarity norm
        # (TwoProd/TwoSum + compensated tree sum) and the ared barrier
        # log-ratio term (log1p of the exact relative slack move).  A few
        # extra elementwise flops per step; see ops/compensated.py.
        "compensated_reductions": False,
        "verbosity": 0,
        "save_inner_iteration": True,
        "wandb_logging": False,
        "do_exit_on_error": True,
        # Checkpoint/resume (absent in the reference; SURVEY.md §5)
        "checkpoint_path": None,
        "checkpoint_every": 30.0,  # seconds
        "resume": False,
        # Accepted for reference-config compatibility; no-ops here.
        # do_euclidean_lincomb / is_euclidean_embedded select between two
        # mathematically equivalent evaluation orders in the reference
        # (RIPTRM.py:457-571); JAX AD computes the same quantities with one
        # fused program either way.  basisfun is superseded by the
        # deterministic closed-form bases (manifolds/*.basis).
        "do_euclidean_lincomb": False,
        "is_euclidean_embedded": False,
        "basisfun": None,
        "TRS_tolresid": 1e-12,
        # TRS_tolhardcase tunes the reference TRSgep's eigenvector-block norm
        # threshold (RIPTRM.py:441,262); the Moré-Sorensen solver here
        # (ops/trs.py) detects the hard case from the secular equation with
        # dtype-eps-scaled thresholds and has no comparable knob.
        "TRS_tolhardcase": 1e-8,
    }


class RiptrmState(NamedTuple):
    x: object
    y: jnp.ndarray
    mu: jnp.ndarray
    tr_radius: jnp.ndarray
    outer_iter: jnp.ndarray  # completed outer iterations
    inner_count: jnp.ndarray  # inner iterations inside current outer step
    # Inner-loop initial values, for budget-exceeded resets (RIPTRM.py:828-842)
    inner_x0: object
    inner_y0: jnp.ndarray
    inner_tr0: jnp.ndarray
    # Exact-mode cache of the materialized Hw / cx at the current point
    # (reference ``is_RepMat_available`` machinery, RIPTRM.py:406-424,677-704).
    # Cached in eigendecomposed form Hw = h_q diag(h_lam) h_q^T: the TRS
    # solve, the second-order criterion and the TRS self-check all consume
    # the spectrum, so caching (lam, Q) instead of the raw matrix removes a
    # dense eigh per cache-hit step.
    cache_valid: jnp.ndarray
    h_lam: jnp.ndarray  # [dim] ascending eigenvalues
    h_q: jnp.ndarray  # [dim, dim] eigenvectors (columns)
    c_vec: jnp.ndarray  # [dim]


def _barrier_ops(problem, x, y, mu):
    """Condensed barrier-KKT operator pieces at (x, y, mu)
    (``RIPTRM.py:727-730``).  Point-dependent primal traces are frozen via
    ``linearize``/``vjp`` so every Hw application inside the tCG loop is
    tangent-only work."""
    c = problem.slack(x)
    lag_hvp = problem.lag_rhess_at(x, y)
    gx = problem.gx_at(x)
    gx_adj = problem.gx_adj_at(x)

    def hw(dx):
        lag = lag_hvp(dx)
        bar = gx((y * gx_adj(dx)) / c)
        return jax.tree.map(lambda a, b: a + b, lag, bar)

    cx_vec = jax.tree.map(lambda a, b: a - b, problem.rgrad(x), gx(mu / c))
    return c, hw, cx_vec


def _log_barrier(problem, x, mu):
    """phi(x) = f(x) - mu * sum log c(x) (``RIPTRM.py:644-649``); guarded so
    the value is finite garbage (never NaN) at infeasible points — callers
    only use it on feasible branches."""
    c = problem.slack(x)
    safe_c = jnp.where(c > 0, c, 1.0)
    return problem.cost(x) + -mu * jnp.sum(jnp.log(safe_c))


def make_step(problem, option):
    """Build the pure inner-step function.  Static: problem, option."""
    man = problem.manifold
    dim = man.dim
    exact = option["TRS_solver"] == "Exact_RepMat"
    trs_method = option["exact_trs_method"]
    if trs_method == "auto":
        trs_method = "ms" if dim >= 256 else "eigh"
    trs_ms = exact and trs_method == "ms"
    second_order = option["second_order_stationarity"]
    ff_lag = option["forcing_function_Lagrangian"]
    ff_compl = option["forcing_function_complementarity"]
    ff_second = option["forcing_function_second_order"]
    inner_maxiter = option["inner_maxiter"]

    def _dense_ritz(h_mat):
        """Extreme Ritz estimates of a dense materialized Hw (32 dense
        matvecs, far cheaper than an eigh of the same matrix)."""
        from riptrm_tpu.ops.spectrum import lanczos

        dt = h_mat.dtype
        v0 = jnp.ones((dim,), dtype=dt) + jnp.linspace(0.0, 1.0, dim, dtype=dt)
        v0 = v0 / jnp.linalg.norm(v0)
        _, _, ritz = lanczos(
            lambda v: h_mat @ v, v0, lambda u, w: u @ w, min(32, dim)
        )
        return ritz[0], ritz[-1]

    # Structured closed-form materialization: for sphere_quadratic problems
    # (cost -x'Zs x, constraints -x) the barrier-KKT operator's ambient form
    # is A = -2 Zs + diag(y/c) with curvature kappa = x'(-2 Zs x - y), so the
    # representing matrix is one O(n^2) Householder congruence instead of dim
    # O(n^2) HVPs (ops/basis.py::sphere_householder_congruence).  Verified
    # against the HVP path to machine precision (tests/test_ops.py).
    structured_sphere = (
        problem.structure is not None
        and problem.structure.get("kind") == "sphere_quadratic"
    )

    def _materialize_structured(x, y, mu):
        from riptrm_tpu.ops.basis import (
            sphere_householder_congruence,
            sphere_householder_coords,
        )

        zs = problem.structure["Zs"].astype(y.dtype)
        c = problem.slack(x)
        zsx = zs @ x
        a_mat = -2.0 * zs + jnp.diag(y / c)
        kappa = x @ (-2.0 * zsx - y)
        h_mat = sphere_householder_congruence(x, a_mat, kappa)
        c_vec = sphere_householder_coords(x, -2.0 * zsx - mu / c)
        return h_mat, c_vec

    def materialize_at(x, y, mu):
        """Exact-mode cache payload at (x, y, mu).

        eigh mode: (eigenvalues, eigenvectors, c_vec) — Hw in decomposed
        form.  ms mode: h_q holds the RAW materialized matrix and h_lam
        carries only the Lanczos extreme estimates at [0]/[-1] (same state
        shapes, so checkpoints and the compiled carries are mode-agnostic).
        """
        if structured_sphere:
            h_mat, c_vec = _materialize_structured(x, y, mu)
        else:
            basis = man.basis(x)
            c, hw, cx = _barrier_ops(problem, x, y, mu)
            h_mat = materialize_symmetrized(man, x, basis, hw)
            c_vec = man.to_coords(x, basis, cx)
        if trs_ms:
            lam_lo, lam_hi = _dense_ritz(h_mat)
            pad = jnp.zeros((dim - 2,), dtype=h_mat.dtype) if dim > 2 else (
                jnp.zeros((0,), dtype=h_mat.dtype)
            )
            h_lam = jnp.concatenate([lam_lo[None], pad, lam_hi[None]])[:dim]
            return h_lam, h_mat, c_vec
        h_lam, h_q = jnp.linalg.eigh(h_mat)
        return h_lam, h_q, c_vec

    def outer_update(mu):
        """Barrier parameter schedule (``RIPTRM.py:890-893``)."""
        r = option["barrier_parameter_update_r"]
        cc = option["barrier_parameter_update_c"]
        b = option["barrier_parameter_update_b"]
        mu_min = option["min_barrier_parameter"]
        simple = cc * mu ** (1.0 + r)
        if option["do_simple_barrier_parameter_update"]:
            return jnp.maximum(mu_min, simple)
        return jnp.maximum(mu_min, jnp.minimum(b * mu, simple))

    def step(state: RiptrmState):
        x, y, mu, tr_radius = state.x, state.y, state.mu, state.tr_radius
        c, hw, cx = _barrier_ops(problem, x, y, mu)

        # ---- direction (RIPTRM.py:426-455) -----------------------------
        if exact:
            h_lam, h_q, c_vec = jax.lax.cond(
                state.cache_valid,
                lambda: (state.h_lam, state.h_q, state.c_vec),
                lambda: materialize_at(x, y, mu),
            )
            basis = man.basis(x)
            if trs_ms:
                from riptrm_tpu.ops.trs import solve_trs_ms

                coeff, lam1, trs_code, _ = solve_trs_ms(
                    h_q, c_vec, tr_radius, lam_est=(h_lam[0], h_lam[-1])
                )
                h_coeff = h_q @ coeff  # h_q holds the raw Hw matrix
                hw_dx_dx = coeff @ h_coeff
            else:
                coeff, lam1, trs_code, p_c = solve_trs_eig(
                    h_lam, h_q, c_vec, tr_radius
                )
                hw_dx_dx = p_c @ (h_lam * p_c)
            dx = man.from_coords(x, basis, coeff)
            cx_dx = c_vec @ coeff
            dxtype = trs_code
            tcg_iters = jnp.asarray(0, jnp.int32)  # exact mode: no tCG
        else:
            dx, h_dx, tcg_iters, tcg_code = truncated_cg(
                man,
                x,
                hw,
                cx,
                tr_radius,
                theta=option["tCG_theta"],
                kappa=option["tCG_kappa"],
                mininner=option["tCG_mininner"],
                maxinner=dim,
            )
            hw_dx_dx = man.inner(x, dx, h_dx)
            cx_dx = man.inner(x, cx, dx)
            dxtype = 10 + tcg_code
            h_lam, h_q, c_vec = state.h_lam, state.h_q, state.c_vec

        normdx = man.norm(x, dx)

        # ---- optional TRS optimality self-check (RIPTRM.py:367-388) ----
        trs_check = {}
        if option["checkTRSoptimality"]:
            if exact:
                mineig_hw, maxeig_hw = h_lam[0], h_lam[-1]
            else:
                basis_c = man.basis(x)
                hm = materialize_symmetrized(man, x, basis_c, hw)
                w_ev = jnp.linalg.eigvalsh(hm)
                mineig_hw, maxeig_hw = w_ev[0], w_ev[-1]
            pred_chk = -0.5 * hw_dx_dx - cx_dx
            cx_norm = man.norm(x, cx)
            cauchy_diff = pred_chk - 0.5 * cx_norm * jnp.minimum(
                tr_radius, cx_norm / maxeig_hw
            )
            eigen_diff = pred_chk + 0.5 * tr_radius**2 * mineig_hw
            trs_check = {
                "TRS_cauchy_diff": cauchy_diff,
                "TRS_eigen_diff": eigen_diff,
                "TRS_mineig": mineig_hw,
            }
            if exact:
                if trs_ms:
                    kkt_vec = h_coeff + lam1 * coeff + c_vec
                else:
                    kkt_vec = h_q @ (h_lam * p_c) + lam1 * coeff + c_vec
                trs_check["TRS_KKTresid"] = jnp.linalg.norm(kkt_vec)
                trs_check["TRS_compl"] = lam1 * (tr_radius - normdx)

        # ---- trial point (RIPTRM.py:743-745) ---------------------------
        dy = -y + mu / c - y * problem.gx_adj(x, dx) / c
        x_new = man.retract(x, dx)
        y_new = y + dy
        c_new = problem.slack(x_new)

        # ---- inner stopping criteria (RIPTRM.py:574-629) ---------------
        xfeas = jnp.all(c_new > 0)
        yfeas = jnp.all(y_new > 0)
        norm_grad_lag = man.norm(x_new, problem.lag_rgrad(x_new, y_new))
        if option["compensated_reductions"]:
            from riptrm_tpu.ops.compensated import complementarity_norm

            compl = complementarity_norm(y_new, c_new, mu)
        else:
            compl = jnp.linalg.norm(y_new * c_new - mu)
        crit_lag = norm_grad_lag <= ff_lag(mu)
        crit_compl = compl <= ff_compl(mu)

        if exact and second_order:
            h_lam_new, h_q_new, c_vec_new = materialize_at(x_new, y_new, mu)
            mineig = h_lam_new[0]
            crit_eig = mineig >= -ff_second(mu)
        elif second_order:
            # Matrix-free second-order criterion for tCG mode: Lanczos Ritz
            # minimum of Hw at the trial point.  Gated behind the
            # first-order criteria (lax.cond) so the extra HVPs only run on
            # steps where they could flip the converged flag.  Ritz minima
            # approach lambda_min from above, so this is an iterative
            # certificate of the same character as the reference's
            # ARPACK-``eigs`` spectra (``utils.py:417-475``).
            from riptrm_tpu.ops.spectrum import lanczos

            h_lam_new, h_q_new, c_vec_new = h_lam, h_q, c_vec
            first_ok = xfeas & yfeas & crit_lag & crit_compl
            k_lan = min(option["second_order_lanczos_iters"], dim)

            def _ritz_min():
                _, hw_new, cx_new = _barrier_ops(problem, x_new, y_new, mu)
                # Deterministic start: barrier gradient plus the transported
                # step direction (no RNG in the solver path).
                v0 = jax.tree.map(
                    lambda a, b: a + 0.5 * b,
                    cx_new,
                    man.transport(x, x_new, dx),
                )
                _, _, ritz = lanczos(
                    hw_new, v0, lambda u, t: man.inner(x_new, u, t), k_lan
                )
                return ritz[0].astype(normdx.dtype)

            mineig = jax.lax.cond(
                first_ok,
                _ritz_min,
                lambda: jnp.asarray(jnp.inf, dtype=normdx.dtype),
            )
            crit_eig = mineig >= -ff_second(mu)
        else:
            h_lam_new, h_q_new, c_vec_new = h_lam, h_q, c_vec
            mineig = jnp.asarray(jnp.nan, dtype=normdx.dtype)
            crit_eig = jnp.asarray(True)

        converged = xfeas & yfeas & crit_lag & crit_compl & crit_eig
        infeasible = (~converged) & (~xfeas)

        # ---- ared / pred and radius update (RIPTRM.py:631-705) ---------
        # The reference computes phi(x) - phi(xNew) with phi = f - mu*sum(log c)
        # (RIPTRM.py:656-658).  The two barrier sums are O(n) magnitudes and
        # cancel catastrophically in f32, so compute the difference directly:
        # ared = [f(x) - f(xNew)] + mu * sum(log(cNew_i / c_i)) — identical in
        # exact arithmetic, conditioned on the (small) per-element ratios.
        if option["compensated_reductions"]:
            from riptrm_tpu.ops.compensated import barrier_log_ratio_sum

            ared_raw = (
                problem.cost(x) - problem.cost(x_new)
            ) + barrier_log_ratio_sum(c_new, c, mu)
        else:
            safe_c = jnp.where(c > 0, c, 1.0)
            ratio = jnp.where((c_new > 0) & (c > 0), c_new / safe_c, 1.0)
            ared_raw = (problem.cost(x) - problem.cost(x_new)) + mu * jnp.sum(
                jnp.log(ratio)
            )
        phi_cur = _log_barrier(problem, x, mu)  # scale only (regularization)
        red_reg = (
            jnp.maximum(1.0, jnp.abs(phi_cur))
            * jnp.finfo(normdx.dtype).eps
            * option["reduction_regularization"]
        )
        ared = ared_raw + red_reg
        pred = -0.5 * hw_dx_dx - cx_dx + red_reg

        shrink = ared < 0.25 * pred
        # Boundary-step detection for expansion (reference: |dx| == TR to
        # 1e-15, RIPTRM.py:670).  1e-15 is an f64 assumption — at f32 it can
        # never fire and the radius never expands; scale with the dtype eps
        # there while keeping exact reference semantics at f64.
        eps_dt = jnp.finfo(normdx.dtype).eps
        boundary_tol = 1e-15 if eps_dt < 1e-12 else 8.0 * eps_dt * tr_radius
        expand = (ared >= 0.75 * pred) & (jnp.abs(normdx - tr_radius) <= boundary_tol)
        tr_updated = jnp.where(
            shrink,
            0.25 * tr_radius,
            jnp.where(
                expand, jnp.minimum(2.0 * tr_radius, option["maximal_TR_radius"]), tr_radius
            ),
        )
        radius_update_code = jnp.where(shrink, 1, jnp.where(expand, 2, 0))
        accepted = ared > option["rho"] * pred

        # dual clipping (RIPTRM.py:681-696); I_right reproduces the reference's
        # np.maximum(a, b, out) semantics: a scalar max broadcast to all i.
        safe_c_new = jnp.where(c_new > 0, c_new, 1.0)
        i_left = option["const_left"] * jnp.minimum(jnp.minimum(y, mu / safe_c_new), 1.0)
        i_right = jnp.maximum(option["const_right"], option["const_right"] / mu)
        y_clipped = jnp.minimum(jnp.maximum(y_new, i_left), i_right)
        dual_clipping = ~jnp.all(y_new == y_clipped)

        # ---- combine branches ------------------------------------------
        status = jnp.where(
            converged,
            INNER_CONVERGED,
            jnp.where(
                infeasible,
                INNER_PRIMAL_INFEASIBLE,
                jnp.where(accepted, INNER_SUCCESSFUL, INNER_UNSUCCESSFUL),
            ),
        )

        take_new_x = converged | ((~infeasible) & accepted)

        def select_point(new, old):
            return jax.tree.map(
                lambda n, o: jnp.where(take_new_x, n, o), new, old
            )

        x_next = select_point(x_new, x)
        y_next = jnp.where(
            converged, y_new, jnp.where((~infeasible) & accepted, y_clipped, y)
        )
        tr_next = jnp.where(
            converged,
            tr_radius,
            jnp.where(infeasible, option["gamma"] * normdx, tr_updated),
        )

        # Cache management (reference RIPTRM.py:677-704): keep the cache on
        # rejected steps; move the xNew materialization into the cache on
        # un-clipped accepts (exact+2nd-order mode); otherwise invalidate.
        if exact:
            reuse_new = (~infeasible) & accepted & (~dual_clipping) & second_order
            keep_old = infeasible | ((~converged) & (~accepted))
            cache_valid = keep_old | reuse_new
            h_lam_next = jnp.where(reuse_new, h_lam_new, h_lam)
            h_q_next = jnp.where(reuse_new, h_q_new, h_q)
            c_vec_next = jnp.where(reuse_new, c_vec_new, c_vec)
        else:
            cache_valid = jnp.asarray(False)
            h_lam_next, h_q_next, c_vec_next = h_lam, h_q, c_vec

        inner_count = state.inner_count + 1

        # inner_maxiter budget (RIPTRM.py:835-842): reset to the inner-loop
        # initial values and force an outer transition.
        if inner_maxiter is not None:
            forced = (~converged) & (inner_count >= inner_maxiter)
        else:
            forced = jnp.asarray(False)
        exit_inner = converged | forced

        x_next = jax.tree.map(
            lambda n, o: jnp.where(forced, o, n), x_next, state.inner_x0
        )
        y_next = jnp.where(forced, state.inner_y0, y_next)
        tr_next = jnp.where(forced, state.inner_tr0, tr_next)
        status = jnp.where(forced, INNER_MAX_ITER, status)

        # ---- outer transition on inner exit (RIPTRM.py:866-896) --------
        mu_next = jnp.where(exit_inner, outer_update(mu), mu)
        tr_next = jnp.where(
            exit_inner,
            jnp.maximum(tr_next, option["minimal_initial_TR_radius"]),
            tr_next,
        )
        outer_iter = state.outer_iter + jnp.where(exit_inner, 1, 0)
        inner_count = jnp.where(exit_inner, 0, inner_count)
        inner_x0 = jax.tree.map(
            lambda n, o: jnp.where(exit_inner, n, o), x_next, state.inner_x0
        )
        inner_y0 = jnp.where(exit_inner, y_next, state.inner_y0)
        inner_tr0 = jnp.where(exit_inner, tr_next, state.inner_tr0)
        cache_valid = cache_valid & ~exit_inner

        new_state = RiptrmState(
            x=x_next,
            y=y_next,
            mu=mu_next,
            tr_radius=tr_next,
            outer_iter=outer_iter,
            inner_count=inner_count,
            inner_x0=inner_x0,
            inner_y0=inner_y0,
            inner_tr0=inner_tr0,
            cache_valid=cache_valid,
            h_lam=h_lam_next,
            h_q=h_q_next,
            c_vec=c_vec_next,
        )

        ev = evaluation(problem, x, x_next, y_next, jnp.zeros((0,)))
        info = dict(ev)
        info.update(
            mu=mu,  # mu of the step that was just taken
            inner_status=status,
            num_inner=state.inner_count + 1,
            TR_radius=tr_radius,  # radius used this step (pre-update)
            dxtype=dxtype,
            normdx=normdx,
            minxfeasi=jnp.min(c_new) if problem.has_ineq else jnp.asarray(jnp.inf),
            minyfeasi=jnp.min(y_new) if problem.has_ineq else jnp.asarray(jnp.inf),
            compl=compl,
            mineigvalHw=mineig,
            ared_pred=ared / pred,
            radius_update=jnp.where(
                converged | infeasible | forced, -1, radius_update_code
            ),
            dual_clipping=jnp.where(
                converged | infeasible | forced,
                -1,
                jnp.where(accepted, dual_clipping.astype(jnp.int32), -1),
            ),
            maxabsLagmult=jnp.max(jnp.abs(y_next)) if problem.has_ineq else jnp.asarray(0.0),
            converged=converged,
            exit_inner=exit_inner,
            outer_iter=outer_iter,
            # HVP-call count of the direction solve this step (tCG
            # iterations; 0 in exact mode) — the dynamic collective count
            # on a data-sharded problem is tcg_iters + O(1) per step
            # (sid_sharded_ratio decomposition)
            tcg_iters=jnp.asarray(tcg_iters, jnp.int32),
        )
        info.update(trs_check)
        return new_state, info

    return step


def make_force_outer(option):
    """Host-triggered inner-budget reset (``RIPTRM.py:823-842``,
    ``inner_maxtime``): revert to the inner loop's initial values and apply
    the outer barrier update."""

    def force_outer(state: RiptrmState):
        r = option["barrier_parameter_update_r"]
        cc = option["barrier_parameter_update_c"]
        b = option["barrier_parameter_update_b"]
        mu_min = option["min_barrier_parameter"]
        simple = cc * state.mu ** (1.0 + r)
        if option["do_simple_barrier_parameter_update"]:
            mu = jnp.maximum(mu_min, simple)
        else:
            mu = jnp.maximum(mu_min, jnp.minimum(b * state.mu, simple))
        tr = jnp.maximum(state.inner_tr0, option["minimal_initial_TR_radius"])
        return state._replace(
            x=state.inner_x0,
            y=state.inner_y0,
            tr_radius=tr,
            mu=mu,
            outer_iter=state.outer_iter + 1,
            inner_count=jnp.asarray(0),
            inner_tr0=tr,
            cache_valid=jnp.asarray(False),
        )

    return force_outer


def init_state(problem, option):
    """``outer_preprocess`` + ``inner_preprocess`` (``RIPTRM.py:849-864,406-424``)."""
    man = problem.manifold
    x0 = problem.x0
    y0 = jnp.asarray(problem.y0)
    mu0 = jnp.asarray(option["initial_barrier_parameter"], dtype=y0.dtype)
    if option["initial_TR_radius"] is None:
        tr0 = man.typical_dist / 8.0
    else:
        tr0 = option["initial_TR_radius"]
    tr0 = jnp.asarray(tr0, dtype=y0.dtype)
    # The materialized-Hw cache lives in the while_loop carry; only the
    # Exact_RepMat path ever reads it, so keep it zero-sized for tCG (for a
    # fixed-rank problem a [dim, dim] carry would dominate the state).
    dim = man.dim if option["TRS_solver"] == "Exact_RepMat" else 0
    dt = y0.dtype
    return RiptrmState(
        x=x0,
        y=y0,
        mu=mu0,
        tr_radius=tr0,
        outer_iter=jnp.asarray(0),
        inner_count=jnp.asarray(0),
        inner_x0=x0,
        inner_y0=y0,
        inner_tr0=tr0,
        cache_valid=jnp.asarray(False),
        h_lam=jnp.zeros((dim,), dtype=dt),
        h_q=jnp.zeros((dim, dim), dtype=dt),
        c_vec=jnp.zeros((dim,), dtype=dt),
    )


class RIPTRM:
    """Host-facing solver wrapper with the reference's run protocol."""

    def __init__(self, option=None):
        self.option = merge_options(default_option(), option or {})
        self.name = f"RIPTRM_{self.option['TRS_solver']}"

    # ------------------------------------------------------------------
    def run(self, problem) -> Output:
        """Wall-clock-budgeted host loop (``RIPTRM.py:909-976``): one jitted
        inner step per iteration, per-iteration logging, reference stopping
        semantics (residual check at outer transitions, budget resets)."""
        option = self.option
        maybe_wandb_init(option, self.name)
        log = LogAccumulator()

        # AOT-compile before starting the clock: the reference's
        # excluded_time mechanism subtracts non-solve overhead
        # (base_solver.py:58-93); compilation is the JAX analog.
        state = init_state(problem, option)
        step = jax.jit(make_step(problem, option)).lower(state).compile()
        eval_fn = (
            jax.jit(lambda s: evaluation(problem, s.x, s.x, s.y, jnp.zeros((0,))))
            .lower(state)
            .compile()
        )
        # Also AOT-compiled here: a lazy jit would compile on the first
        # inner-budget reset *inside* the timed loop, charging (potentially
        # large, see CLAUDE.md remote-compile latency) compile seconds
        # against maxtime.
        force_outer = (
            jax.jit(make_force_outer(option)).lower(state).compile()
            if option["inner_maxtime"] is not None
            else None
        )

        # Resume from a checkpoint (state + elapsed budget + log so far)
        ckpt_path = option.get("checkpoint_path")
        initial_elapsed = 0.0
        resumed = False
        if ckpt_path and option.get("resume") and os.path.exists(ckpt_path):
            from riptrm_tpu.experiment.checkpoint import load_state

            state, meta = load_state(ckpt_path, state)
            initial_elapsed = float(meta.get("elapsed", 0.0))
            for k, v in meta.get("log", {}).items():
                log.log[k] = list(v)
            resumed = True
        clock = WallClock(option["maxtime"], initial_elapsed)
        last_ckpt = clock.elapsed()
        inner_start = clock.elapsed()

        eval0 = eval_fn(state)
        # iteration-0 row (outer loop first evaluation, RIPTRM.py:931-944)
        status0 = {
            "mu": state.mu,
            "num_inner": None,
            "inner_status": None,
            "TR_radius": None,
            "dxtype": None,
            "normdx": None,
            "minxfeasi": None,
            "minyfeasi": None,
            "compl": None,
            "mineigvalHw": None,
            "ared/pred": None,
            "radius_update": None,
            "dual_clipping": None,
            "maxabsLagmult": float(jnp.max(jnp.abs(state.y))) if problem.has_ineq else 0.0,
        }
        if not resumed:  # iteration-0 row already in the restored log
            log.add(0, 0.0, eval0, status0)
            maybe_wandb_log(
                option, {**{k: float(v) for k, v in eval0.items()}, "time": 0.0}
            )

        stop_reason = None
        if float(eval0["residual"]) <= option["tolresid"]:
            stop_reason = f"KKT residual tolerance reached; current residual={float(eval0['residual'])} and tolresid={option['tolresid']}"

        while stop_reason is None:
            try:
                state, info = step(state)
                # ONE device->host transfer for stop logic + logging; the
                # previous per-field conversions were ~27 separate fetches
                # per row, which dominated long protocol runs.
                info = jax.device_get(info)
                converged = bool(info["converged"])
                residual = float(info["residual"])
            except Exception as e:  # do_exit_on_error (RIPTRM.py:961-966)
                if option["do_exit_on_error"]:
                    print(f"Error: {e}")
                    break
                raise

            outer_iter = int(info["outer_iter"])
            # The reference logs inner rows under the *current* outer
            # iteration number (1-based); outer_iter counts completed outer
            # iterations, so the row belongs to outer_iter when this step
            # exited the inner loop and outer_iter + 1 otherwise.
            row_iter = outer_iter if bool(info["exit_inner"]) else outer_iter + 1
            row_time = clock.elapsed()
            # save_inner_iteration=False logs only at outer transitions
            # (reference outer loop add_log, RIPTRM.py:936-941)
            if option["save_inner_iteration"] or bool(info["exit_inner"]):
                # Excluded from the budget like the reference's
                # ``excluded_time`` (base_solver.py:58-93): on 1e5-row runs
                # the per-field device->host conversions are material.
                t_log = time.time()
                row = self._format_info(info)
                log.add(row_iter, row_time, row)
                maybe_wandb_log(option, row | {"time": row_time})
                clock.excluded += time.time() - t_log

            if ckpt_path and row_time - last_ckpt >= option["checkpoint_every"]:
                from riptrm_tpu.experiment.checkpoint import save_state

                save_state(
                    ckpt_path,
                    state,
                    {"elapsed": row_time, "log": log.as_dict()},
                )
                last_ckpt = row_time

            if option["verbosity"] >= 1 and converged:
                print(
                    f"Outer iteration: {outer_iter}, Cost: {float(info['cost'])}, "
                    f"KKT residual: {residual}, mu: {float(info['mu'])}"
                )
            elif option["verbosity"] > 1:
                print(
                    f"Iter: {row_iter}-{int(info['num_inner'])}, "
                    f"Cost: {float(info['cost']):.3e}, KKT resid: {residual:.3e}, "
                    f"TR: {float(info['TR_radius']):.3e}, "
                    f"Stat: {INNER_STATUS_NAMES[int(info['inner_status'])]}"
                )

            # Wall-clock budget: revert to the inner loop's initial point
            # (RIPTRM.py:823-834) and stop.
            if clock.exceeded():
                state = state._replace(
                    x=state.inner_x0, y=state.inner_y0, tr_radius=state.inner_tr0
                )
                stop_reason = (
                    f"Max time exceeded; runtime={clock.elapsed():.2f} and "
                    f"maxtime={option['maxtime']}"
                )
                break

            # inner_maxtime budget: reset the inner loop and force the outer
            # transition (RIPTRM.py:822-834)
            if (
                option["inner_maxtime"] is not None
                and not bool(info["exit_inner"])
                and clock.elapsed() - inner_start >= option["inner_maxtime"]
            ):
                state = force_outer(state)
                inner_start = clock.elapsed()
            elif bool(info["exit_inner"]):
                inner_start = clock.elapsed()
            if converged:
                if residual <= option["tolresid"]:
                    stop_reason = (
                        "KKT residual tolerance reached; current residual="
                        f"{residual} and tolresid={option['tolresid']}"
                    )
                    break
            if outer_iter >= option["maxiter"]:
                stop_reason = (
                    f"Max iteration count reached; maxiter={option['maxiter']} "
                    f"after {clock.elapsed():.2f} seconds"
                )
                break

        self.option["stoppingcriterion"] = stop_reason
        maybe_wandb_finish(option)
        opt_out = {k: v for k, v in self.option.items() if not callable(v)}
        return Output(
            name=self.name,
            x=jax.tree.map(lambda a: a, state.x),
            ineqLagmult=state.y,
            eqLagmult=jnp.zeros((0,)),
            option=copy.deepcopy(opt_out),
            log=log.as_dict(),
        )

    @staticmethod
    def _format_info(info) -> dict:
        """Map jnp status codes to the reference's string log values."""
        out = {}
        for k, v in info.items():
            if k in ("converged", "exit_inner", "outer_iter", "tcg_iters"):
                # tcg_iters is measurement-harness metadata, not a
                # reference log column (CSV contract stays reference-shaped)
                continue
            out[k] = v
        status = int(info["inner_status"])
        out["inner_status"] = INNER_STATUS_NAMES[status]
        dxt = int(info["dxtype"])
        out["dxtype"] = TCG_NAMES[dxt - 10] if dxt >= 10 else TRS_NAMES[dxt]
        out["radius_update"] = RADIUS_NAMES[int(info["radius_update"])]
        dc = int(info["dual_clipping"])
        out["dual_clipping"] = None if dc < 0 else bool(dc)
        out["ared/pred"] = out.pop("ared_pred")
        return out

    # ------------------------------------------------------------------
    def _solve_loop(self, problem, max_steps: int):
        """Compiled solve loop: solve(state, target) -> (state, steps,
        done, best).  Both public variants below delegate to it; the
        freeze/best/target machinery is the shared
        ``base.compiled_best_while`` (``solve_compiled_traced`` keeps its
        own loop because of the trace buffers — keep its stop logic in
        sync with ``step1`` below)."""
        from riptrm_tpu.ops.kkt import compute_residual
        from riptrm_tpu.solvers.base import compiled_best_while

        option = self.option
        step = make_step(problem, option)
        tolresid = option["tolresid"]
        maxiter = option["maxiter"]

        def step1(st):
            new_st, info = step(st)
            # The protocol metric counts only inner-converged steps (the
            # reference's analyzers filter RIPTRM rows to
            # ``inner_status == converged``) — plus the iteration-0 row,
            # which seeds best below.
            counted = info["converged"]
            stop = (
                info["converged"] & (info["residual"] <= tolresid)
            ) | (new_st.outer_iter >= maxiter)
            return new_st, info["residual"], counted, stop

        def solve(state, target):
            best0 = compute_residual(
                problem, state.x, state.y, jnp.zeros((0,))
            )[0]
            # keep_best_point (opt-in, default False): return the
            # inner-converged iterate with the lowest residual instead of
            # the final state.  Off for normal solves (the trajectory is
            # near-monotone and the extra state carry is wasted); ON for
            # floor-chasing continuations (staged precision), where the
            # loop churns at the noise floor after the dip and a
            # stall-window freeze would otherwise hand back a
            # worse-than-entry state (measured on-chip: staged phase 2
            # ended at 5.9e-3 with its best at <= 1.8e-4).
            return compiled_best_while(
                step1, state, target, max_steps, best0,
                stall_window=option.get("sweep_stall_window"),
                track_best_state=option.get("keep_best_point", False),
            )

        return solve

    # ------------------------------------------------------------------
    def solve_compiled(self, problem, max_steps: int, return_done: bool = False):
        """Fully-compiled fixed-budget solve (lax.while_loop) for vmapped /
        sharded sweeps and benchmarks.  Returns the final state and the
        number of inner steps executed; with ``return_done`` also the
        internal stop flag, which distinguishes "hit its stopping criterion"
        from "exhausted max_steps" — segmented (checkpointed) sweeps need
        this to compose segments exactly (a lane can converge precisely on
        a segment's last step, where k alone is ambiguous)."""
        inner = self._solve_loop(problem, max_steps)

        def solve(state):
            st, k, done, _ = inner(state, -jnp.inf)
            return (st, k, done) if return_done else (st, k)

        return solve

    # ------------------------------------------------------------------
    def solve_compiled_best(self, problem, max_steps: int):
        """Compiled solve tracking the PROTOCOL metric: the best KKT
        residual over inner-converged steps (SURVEY §6 "minimum KKT
        residual reached within budget").

        Returns solve(state, target) -> (state, steps, best): the loop
        additionally stops once ``best <= target`` (time-to-target runs,
        ``experiment/protocol_speedrun.py``); pass target = 0 (or -inf) to
        run the full maxiter/tolresid schedule.
        """
        inner = self._solve_loop(problem, max_steps)

        def solve(state, target):
            st, k, _, best = inner(state, target)
            return st, k, best

        return solve

    # ------------------------------------------------------------------
    def solve_compiled_traced(self, problem, max_steps: int):
        """Compiled solve that also records a compact per-step trace into
        fixed buffers (SURVEY §7.7: per-iteration log capture from stacked
        outputs) so batched/sharded sweeps retain residual trajectories.

        Returns solve(state) -> (state, steps, trace) where trace is a dict
        of [max_steps] arrays (residual, mu, cost, inner_status, outer_iter);
        rows beyond ``steps`` hold NaN / -1.
        """
        option = self.option
        step = make_step(problem, option)
        tolresid = option["tolresid"]
        maxiter = option["maxiter"]

        def solve(state):
            dt = state.mu.dtype
            nan = jnp.asarray(jnp.nan, dtype=dt)
            buf0 = {
                "residual": jnp.full((max_steps,), nan),
                "mu": jnp.full((max_steps,), nan),
                "cost": jnp.full((max_steps,), nan),
                "inner_status": jnp.full((max_steps,), -1, dtype=jnp.int32),
                "outer_iter": jnp.full((max_steps,), -1, dtype=jnp.int32),
            }

            def cond(carry):
                state, k, done, _ = carry
                return (~done) & (k < max_steps)

            def body(carry):
                state, k, done, buf = carry
                new_state, info = step(state)
                new_done = done | (
                    info["converged"] & (info["residual"] <= tolresid)
                ) | (new_state.outer_iter >= maxiter)
                row = {
                    "residual": info["residual"],
                    "mu": info["mu"],
                    "cost": info["cost"],
                    "inner_status": info["inner_status"].astype(jnp.int32),
                    "outer_iter": new_state.outer_iter.astype(jnp.int32),
                }
                buf = {
                    name: jnp.where(done, arr, arr.at[k].set(row[name]))
                    for name, arr in buf.items()
                }
                state_out = jax.tree.map(
                    lambda old, new: jnp.where(done, old, new), state, new_state
                )
                return (state_out, k + jnp.where(done, 0, 1), new_done, buf)

            state, k, _, buf = jax.lax.while_loop(
                cond, body, (state, jnp.asarray(0), jnp.asarray(False), buf0)
            )
            return state, k, buf

        return solve
