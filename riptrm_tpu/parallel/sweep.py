"""Parallel sweep execution: vmap within a chip, shard_map across the mesh.

The reference's only concurrency is Hydra multirun forking one OS process
per (instance, initial point, solver) combination (SURVEY.md §2.3).  Here
the sweep axes become a *batch axis* —

* ``vmap`` batches whole compiled solves over stacked initial points on one
  chip (the solver state machines are pure, so masked lockstep batching is
  free);
* ``shard_map`` over a ``Mesh`` axis ``dp`` distributes the batch across
  devices, with convergence-stat reductions as collectives;
* for large single instances, problem data (e.g. NonnegPCA's Z matrix) is
  sharded over a ``tp`` axis with ``NamedSharding`` so XLA partitions the
  Hessian-vector matvecs and inserts the collectives.
"""

from __future__ import annotations

import os

import jax
import jax.numpy as jnp
import numpy as np
from jax.sharding import Mesh, PartitionSpec as P

from riptrm_tpu.ops.kkt import compute_residual
from riptrm_tpu.solvers.riptrm import RIPTRM, RiptrmState, init_state


def _batched_exact_defaults(option):
    """Batched-sweep option defaults for exact mode.

    Under vmap the eigh-cache ``lax.cond`` lowers to select, so the cached
    eigendecomposition that makes the eigh TRS fast in single-lane solves
    is DEAD WEIGHT in a sweep (the batched eigh runs every step), so the
    Cholesky-based Moré-Sorensen TRS is the cheaper batched default (one
    factorization per Newton step instead of a full eigendecomposition;
    not yet measured on the GPU).  Default ``exact_trs_method`` to 'ms' for
    batched builders unless the caller set it explicitly ('auto' keeps the
    dim-256 crossover for single-lane host runs, where the cache is live).
    """
    if (
        option
        and option.get("TRS_solver") == "Exact_RepMat"
        and "exact_trs_method" not in option
    ):
        option = dict(option)
        option["exact_trs_method"] = "ms"
    return option


def _warn_vmapped_lanczos(option: dict):
    """Under vmap, ``lax.cond`` lowers to ``select``: both branches execute.
    The tCG-mode second-order Lanczos certificate (gated behind the
    first-order criteria in single-lane solves) therefore runs its
    ``second_order_lanczos_iters`` HVPs on EVERY step of EVERY lane in a
    batched sweep.  Warn so callers can disable it (and certify the final
    points post-hoc with ``ops.spectrum.lanczos`` instead, one vmapped call)."""
    if option.get("TRS_solver") == "tCG" and option.get(
        "second_order_stationarity", True
    ):
        import warnings

        warnings.warn(
            "Batched sweep with TRS_solver='tCG' and second_order_stationarity=True: "
            "under vmap the Lanczos second-order check executes unconditionally on "
            "every inner step of every lane (lax.cond lowers to select), costing "
            "second_order_lanczos_iters extra HVPs per step. Consider "
            "second_order_stationarity=False plus a post-hoc certificate at the "
            "final points.",
            stacklevel=3,
        )


def make_mesh(axis_sizes: dict, devices=None) -> Mesh:
    devices = devices if devices is not None else jax.devices()
    names = tuple(axis_sizes)
    sizes = tuple(axis_sizes[n] for n in names)
    n_needed = int(np.prod(sizes))
    mesh_devices = np.asarray(devices[:n_needed]).reshape(sizes)
    return Mesh(mesh_devices, names)


def init_state_from(problem, option, x0, y0) -> RiptrmState:
    """RIPTRM initial state for an arbitrary start (vmappable)."""
    base = init_state(problem, option)
    return base._replace(x=x0, y=y0, inner_x0=x0, inner_y0=y0)


def batched_riptrm_solve(problem, option, max_steps: int):
    """vmapped compiled RIPTRM solve over stacked (x0, y0).

    Returns a jitted function (xs0, ys0) -> (final states, steps, residuals).
    Divergent per-instance convergence is handled by each lane's
    while_loop running to its own stop (batched lanes run in lockstep to
    the slowest — the masked-batching tradeoff called out in SURVEY §7).
    """
    solver = RIPTRM(_batched_exact_defaults(option))
    _warn_vmapped_lanczos(solver.option)
    solve = solver.solve_compiled(problem, max_steps)

    def one(x0, y0):
        state, k = solve(init_state_from(problem, solver.option, x0, y0))
        res = compute_residual(problem, state.x, state.y, jnp.zeros((0,)))[0]
        return state, k, res

    return jax.jit(jax.vmap(one))


def batched_riptrm_continue(problem, option, max_steps: int):
    """vmapped compiled RIPTRM solve CONTINUING from prior final states.

    Phase 2 of a staged-precision sweep: re-enters the
    compiled solve at each lane's frozen (x, y, mu, tr) so the barrier
    schedule resumes where phase 1 stalled, with the outer/inner counters
    and the inner-reset anchors re-seeded (phase 1 typically spent part of
    its ``maxiter`` budget; the continuation gets a fresh budget plus its
    own — typically tighter — tolerances and forcing floors from
    ``option``).  The exact-mode Hw cache is invalidated: the new
    program's matvec precision changes the materialization.

    The continuation runs with ``keep_best_point`` on (overridable): it
    operates AT the precision floor by design, so the post-dip churn must
    not degrade the handed-back state below the entry point.
    """
    option = {"keep_best_point": True, **(option or {})}
    solver = RIPTRM(_batched_exact_defaults(option))
    _warn_vmapped_lanczos(solver.option)
    solve = solver.solve_compiled(problem, max_steps)

    def one(st):
        st = st._replace(
            outer_iter=jnp.asarray(0),
            inner_count=jnp.asarray(0),
            inner_x0=st.x,
            inner_y0=st.y,
            inner_tr0=st.tr_radius,
            cache_valid=jnp.asarray(False),
        )
        state, k = solve(st)
        res = compute_residual(problem, state.x, state.y, jnp.zeros((0,)))[0]
        return state, k, res

    return jax.jit(jax.vmap(one))


def staged_precision_riptrm_solve(problem_lo, problem_hi, option_lo,
                                  option_hi, max_steps: int):
    """Two-phase staged-matvec-precision batched solve, ONE jit program.

    Phase 1 runs the cheap-matvec program (``problem_lo``, e.g. 'high')
    to its f32 residual floor; phase 2 CONTINUES every lane under the
    expensive-matvec program (``problem_hi``, e.g. 'highest') with the
    tighter tolerances/floors of ``option_hi``.  This is the batched form
    of "escalate matvec precision once mu is small":
    in-graph mu-gating is useless for batched sweeps — vmap turns
    ``lax.cond`` into ``select`` so BOTH precision branches would execute
    every step (CLAUDE.md batching economics) — while phase-splitting
    pays the 2x matvec passes only for the late-mu steps that need them.

    Returns solve(xs0, ys0) -> (final states, per-lane total steps,
    final residuals, phase-1 residuals).
    """
    s1 = batched_riptrm_solve(problem_lo, option_lo, max_steps)
    s2 = batched_riptrm_continue(problem_hi, option_hi, max_steps)

    def run(xs0, ys0):
        st1, k1, res1 = s1(xs0, ys0)
        st2, k2, res2 = s2(st1)
        return st2, k1 + k2, res2, res1

    return jax.jit(run)


def staged_precision_riptrm_compacted(
    problem_lo, problem_hi, option_lo, option_hi, max_steps: int,
    segment_steps: int = 100, stall_rtol: float = 1e-2,
):
    """Staged-precision solve with CONVERGED-LANE COMPACTION: phase 2 runs as host-driven segments, and between segments
    still-running lanes are gathered into a smaller dense batch so lanes
    that already hit the 'highest' floor stop burning lockstep budget (the
    round-4 one-jit staged program ran ALL lanes for the full continuation
    budget — a 30x throughput penalty once most lanes had floored).

    The active batch is rounded up to the next power of two (padding by
    repeating an active lane) so at most log2(B) distinct programs
    compile — unbounded shape churn would spend the savings on
    compilation.

    A lane leaves the active set when it (a) reaches ``option_hi``'s
    tolresid, or (b) improves by less than ``stall_rtol`` relative over a
    whole segment (= floored).  Returns a host function
    run(xs0, ys0) -> (per-lane best residuals phase 2, phase-1 residuals,
    lane_segments) — states stay device-side per segment; the final
    best-residual bookkeeping is host-side numpy.
    """
    import numpy as np_

    option_hi = {"keep_best_point": True, **(option_hi or {})}
    s1 = batched_riptrm_solve(problem_lo, option_lo, max_steps)
    cont = batched_riptrm_continue(problem_hi, option_hi, segment_steps)
    tol = option_hi.get("tolresid", 1e-6)
    max_segments = max(1, max_steps // segment_steps)

    def run(xs0, ys0):
        st, k1, res1 = s1(xs0, ys0)
        batch = int(np_.asarray(res1).shape[0])
        best = np_.asarray(res1).copy()
        segments_used = np_.zeros((batch,), np_.int64)
        active = np_.ones((batch,), bool)
        st_host = st  # stacked RiptrmState, device-side

        for seg in range(max_segments):
            if not active.any():
                break
            idx = np_.nonzero(active)[0]
            b = 1 << int(np_.ceil(np_.log2(len(idx))))
            b = min(b, batch)
            pad = np_.concatenate([idx, np_.full((b - len(idx),), idx[0])])
            sub = jax.tree.map(lambda a: a[jnp.asarray(pad)], st_host)
            sub2, k2, res2 = cont(sub)
            res2 = np_.asarray(res2)
            # merge back (first pad occurrence only; duplicates dropped)
            merge_rows = jnp.asarray(idx)
            st_host = jax.tree.map(
                lambda full, part: full.at[merge_rows].set(
                    part[: len(idx)]
                ),
                st_host, sub2,
            )
            prev = best[idx]
            now = res2[: len(idx)]
            improved = now < prev
            best[idx] = np_.where(improved, now, prev)
            segments_used[idx] += 1
            floored = now > (1.0 - stall_rtol) * prev
            active[idx] = ~((now <= tol) | floored)
        return best, np_.asarray(res1), segments_used

    return run


def batched_ripm_continue(problem, option, max_steps: int):
    """vmapped compiled RIPM solve CONTINUING from prior final RipmStates
    (phase 2 of a staged-precision sweep — the RIPTRM two-phase pattern generalizes: phase boundaries are program
    boundaries).  The iteration counter is re-seeded and the merit /
    centering scalars (phi, sigma, rho, tau_1, tau_2) are RECOMPUTED
    under the new program — the continuation problem's matvec precision
    changes phi, and a stale phi would corrupt the first Armijo test.
    Runs with ``keep_best_point`` on (overridable): the continuation
    operates at the precision floor, so post-dip churn must not hand back
    a worse state than its own best."""
    from riptrm_tpu.solvers import ripm

    option = {"keep_best_point": True, **(option or {})}
    solve = ripm.solve_compiled_best(problem, option, max_steps)
    m = problem.num_ineq

    def one(st):
        f = ripm._kkt_field(problem, st.x, st.y, st.z, st.s)
        phi = ripm._phi(problem, st.x, *f)
        st = st._replace(
            phi=phi,
            sigma=jnp.minimum(0.5, phi**0.25),
            rho=jnp.vdot(st.z, st.s) / m,
            iteration=jnp.asarray(0),
        )
        tau_1 = jnp.min(st.z * st.s) * m / jnp.vdot(st.z, st.s)
        tau_2 = jnp.vdot(st.z, st.s) / jnp.sqrt(phi)
        state, k, best = solve(st, tau_1, tau_2, -jnp.inf)
        res = compute_residual(problem, state.x, state.z, state.y)[0]
        return state, k, res

    return jax.jit(jax.vmap(one))


def staged_precision_ripm_solve(problem_lo, problem_hi, option_lo,
                                option_hi, max_steps: int):
    """Two-phase staged-matvec-precision batched RIPM solve, ONE jit
    program (the RIPM port of ``staged_precision_riptrm_solve`` — same
    economics: in-graph precision gating is useless under vmap, so the
    escalation is a program boundary).  Phase 1 runs ``problem_lo``
    (e.g. 'high' matvecs) to its floor; phase 2 continues every
    lane under ``problem_hi`` (e.g. 'highest') with ``option_hi``'s
    tighter Krylov/residual tolerances.

    Returns solve(xs0, ys0) -> (final states, per-lane total steps,
    final residuals, phase-1 residuals)."""
    from riptrm_tpu.solvers import ripm

    solve1, start1, _ = _solver_plumbing(
        problem_lo, "RIPM", option_lo, max_steps
    )
    cont = batched_ripm_continue(problem_hi, option_hi, max_steps)

    def one1(x0, y0):
        st0, extras = start1(x0, y0)
        st, k, _ = solve1(st0, *extras, -jnp.inf)
        res = compute_residual(problem_lo, st.x, st.z, st.y)[0]
        return st, k, res

    v1 = jax.vmap(one1)

    def run(xs0, ys0):
        st1, k1, res1 = v1(xs0, ys0)
        st2, k2, res2 = cont(st1)
        return st2, k1 + k2, res2, res1

    return jax.jit(run)


def sharded_riptrm_solve(problem, option, max_steps: int, mesh: Mesh, axis: str = "dp"):
    """shard_map of the vmapped solve over a mesh axis.

    xs0/ys0 leading (batch) dimension must be divisible by the axis size.
    Residuals are returned fully replicated via an all_gather so every host
    can act on global convergence stats.
    """
    solver = RIPTRM(_batched_exact_defaults(option))
    _warn_vmapped_lanczos(solver.option)
    solve = solver.solve_compiled(problem, max_steps)

    def one(x0, y0):
        state, k = solve(init_state_from(problem, solver.option, x0, y0))
        res = compute_residual(problem, state.x, state.y, jnp.zeros((0,)))[0]
        return state.x, state.y, k, res

    vone = jax.vmap(one)

    def shard_fn(xs0, ys0):
        xs, ys, ks, res = vone(xs0, ys0)
        res_all = jax.lax.all_gather(res, axis, tiled=True)
        return xs, ys, ks, res_all

    spec = P(axis)
    # check_vma=False: solver while_loop carries start from literal
    # (device-invariant) values; the varying-manual-axes check would force
    # pvary noise through every carry component.
    fn = jax.shard_map(
        shard_fn,
        mesh=mesh,
        in_specs=(spec, spec),
        out_specs=(spec, spec, spec, P()),
        check_vma=False,
    )
    return jax.jit(fn)


def _solver_plumbing(problem, solver_name: str, option, max_steps: int):
    """Shared per-solver setup for the batched sweep variants.

    Returns (solve, start, resid_args) where ``solve(st0, *extras, target)
    -> (state, steps, best)`` is the solver's best-tracking compiled loop
    (``solve_compiled`` is the same loop at target = -inf),
    ``start(x0, y0) -> (st0, extras)`` builds a lane's initial state, and
    ``resid_args(st) -> (x, ineq_mult, eq_mult)`` extracts the
    KKT-residual arguments in the solver's convention.
    """
    from riptrm_tpu.solvers import ralm, ripm, rsqo

    if solver_name == "RIPTRM":
        solver = RIPTRM(_batched_exact_defaults(option))
        _warn_vmapped_lanczos(solver.option)
        solve = solver.solve_compiled_best(problem, max_steps)

        def start(x0, y0):
            return init_state_from(problem, solver.option, x0, y0), ()

        def resid_args(st):
            return st.x, st.y, jnp.zeros((0,))

    elif solver_name == "RIPM":
        solve = ripm.solve_compiled_best(problem, option, max_steps)
        opt = ripm.RIPM(option).option

        def start(x0, y0):
            base, _, _ = ripm.init_state(problem, opt)
            f = ripm._kkt_field(problem, x0, base.y, y0, y0)
            phi0 = ripm._phi(problem, x0, *f)
            m = problem.num_ineq
            st0 = base._replace(
                x=x0, z=y0, s=y0, phi=phi0,
                sigma=jnp.minimum(0.5, phi0**0.25),
                rho=jnp.vdot(y0, y0) / m,
            )
            tau_1 = jnp.min(y0 * y0) * m / jnp.vdot(y0, y0)
            tau_2 = jnp.vdot(y0, y0) / jnp.sqrt(phi0)
            return st0, (tau_1, tau_2)

        def resid_args(st):
            return st.x, st.z, st.y

    elif solver_name == "RSQO":
        solve = rsqo.solve_compiled_best(problem, option, max_steps)
        opt = rsqo.RSQO(option).option

        def start(x0, y0):
            return rsqo.init_state(problem, opt)._replace(x=x0, y=y0), ()

        def resid_args(st):
            return st.x, st.y, st.z

    elif solver_name == "RALM":
        solve = ralm.solve_compiled_best(problem, option, max_steps)
        opt = ralm.RALM(option).option

        def start(x0, y0):
            st0 = ralm.init_state(problem, opt)._replace(x=x0, y=y0, y_unbd=y0)
            return st0, ()

        def resid_args(st):
            return st.x, st.y, st.z

    else:
        raise ValueError(f"Unknown solver {solver_name}")

    return solve, start, resid_args


def batched_solver_sweep(problem, solver_name: str, option, max_steps: int):
    """Batched compiled solve for ANY of the four solvers.

    Returns a jitted fn (xs0, ys0) -> (x_final, y_final, steps, residuals);
    the sweep axis is the leading dimension of the stacked initial
    primal/dual points (the reference's Hydra multirun axes; SURVEY §2.3).
    """
    solve, start, resid_args = _solver_plumbing(
        problem, solver_name, option, max_steps
    )

    def one(x0, y0):
        st0, extras = start(x0, y0)
        st, k, _ = solve(st0, *extras, -jnp.inf)
        x, ineq, eq = resid_args(st)
        res = compute_residual(problem, x, ineq, eq)[0]
        return x, ineq, k, res

    return jax.jit(jax.vmap(one))


def batched_protocol_sweep(problem, solver_name: str, option, max_steps: int):
    """Batched TIME-TO-TARGET solves for the reference protocol
    (SURVEY §6: "minimum KKT residual reached within budget").

    Like ``batched_solver_sweep`` (same per-solver init plumbing) but each
    lane carries the best-residual-so-far and stops as soon as it reaches
    its per-lane ``target`` (e.g. the residual the full-budget host
    protocol achieved, ``result/benchmark_summary.json``) — the honest
    measurement for "solve the paper's sweep to reference optimality in a
    fraction of the wall clock" (BASELINE.json north star).

    Returns a jitted fn (xs0, ys0, targets) -> (x, y, steps, best).
    """
    solve, start, resid_args = _solver_plumbing(
        problem, solver_name, option, max_steps
    )

    def one(x0, y0, target):
        st0, extras = start(x0, y0)
        st, k, best = solve(st0, *extras, target)
        x, ineq, _ = resid_args(st)
        return x, ineq, k, best

    return jax.jit(jax.vmap(one))


def protocol_single(problem, solver_name: str, option, max_steps: int):
    """UNBATCHED time-to-target solve — the rescue path for lanes that miss
    their target under vmapped reduction ordering.

    Same plumbing as ``batched_protocol_sweep`` but without the vmap: the
    compiled program is the scalar-lane one whose trajectories reproduce
    the host protocol exactly (a batched StableIdentification RSQO lane
    that diverges under vmap re-reaches its 7.95e-15 target unbatched in
    float64 on the CPU — vmapped lanes see different reduction orderings at chaotic
    accept/reject plateaus, CLAUDE.md invariants).

    Returns a jitted fn (x0, y0, target) -> (x, ineq_mult, steps, best).
    """
    solve, start, resid_args = _solver_plumbing(
        problem, solver_name, option, max_steps
    )

    def one(x0, y0, target):
        st0, extras = start(x0, y0)
        st, k, best = solve(st0, *extras, target)
        x, ineq, _ = resid_args(st)
        return x, ineq, k, best

    return jax.jit(one)


def instance_batched_riptrm(option, max_steps: int, problem_builder=None):
    """Batch over problem *instances* x initial points simultaneously
    (BASELINE.json config 4: "NonnegPCA large-n batched: vmapped instances
    x multi-start initial points on one host").

    The problem is constructed inside the vmapped function, so the instance
    data is a traced, batched argument — instances and starts fuse into one
    batched compiled solve.

    ``problem_builder(instance_data, x0) -> Problem`` defaults to NonnegPCA
    (instance_data = Z); any family works as long as its data and points
    stack along a leading batch axis (e.g. ``low_rank.make_problem`` with
    instance_data = A and x0 a stacked (U, S, V) pytree).

    Returns a jitted fn (data [B, ...], xs0 [B, ...], ys0 [B, m]) ->
    (x_final, y_final, steps, residuals).
    """
    if problem_builder is None:
        from riptrm_tpu.problems import nonneg_pca

        problem_builder = nonneg_pca.make_problem

    _warn_vmapped_lanczos(RIPTRM(_batched_exact_defaults(option)).option)

    def one(data, x0, y0):
        problem = problem_builder(data, x0)
        solver = RIPTRM(_batched_exact_defaults(option))
        solve = solver.solve_compiled(problem, max_steps)
        st, k = solve(init_state_from(problem, solver.option, x0, y0))
        res = compute_residual(problem, st.x, st.y, jnp.zeros((0,)))[0]
        return st.x, st.y, k, res

    return jax.jit(jax.vmap(one))


def certify_second_order(problem, xs, ys, *, num_iters=64, ratio_cap=None):
    """Post-hoc second-order certificates for a batch of final points.

    One vmapped matrix-free Lanczos per lane: returns the Ritz minimum of
    the condensed barrier Hessian Hw at each (x, y) — an upper bound
    converging to lambda_min, the same certificate RIPTRM's tCG mode checks
    in-loop (``solvers/riptrm.py``; reference min-eigenvalue criterion,
    ``RIPTRM.py:574-629``).  This is the efficient companion to
    ``_warn_vmapped_lanczos``: run the batched sweep with
    ``second_order_stationarity=False`` (no per-step HVP burn under vmap)
    and certify every lane's final point here with ONE batched call.

    Hw does not depend on the barrier parameter mu (mu only shifts the
    gradient cx), so no mu argument is needed.

    ``ratio_cap`` clamps the barrier RATIO w = y/c inside the (PSD) barrier
    term G diag(w) G' ONLY — the Lagrangian-Hessian term keeps the true
    multipliers, so Hw_true - Hw_capped = G diag(y/c - w) G' is PSD and the
    capped certificate is conservative (if it clears -tol, so does the
    true Hw).  Needed at deeply-converged KKT points, where active
    constraints give y/c -> 1/c ~ 1e30 and an uncapped Lanczos returns
    rounding garbage of that scale.

    The conservativeness argument requires FEASIBILITY (c > 0 for every
    constraint, so each true barrier weight y/c >= any clamped w): at an
    infeasible point a constraint with c < 0 has a NEGATIVE true weight,
    and substituting w = 0 would OVER-report lambda_min.  Capped
    certificates for lanes with min(slack) <= 0 are therefore returned as
    NaN — certify such lanes only after restoring feasibility.
    """
    from riptrm_tpu.ops.spectrum import lanczos
    from riptrm_tpu.solvers.riptrm import _barrier_ops

    man = problem.manifold
    k = min(num_iters, man.dim)

    def one(x, y):
        feasible = jnp.array(True)
        if ratio_cap is None:
            _, hw, cx = _barrier_ops(problem, x, y, jnp.zeros((), dtype=y.dtype))
        else:
            c = problem.slack(x)
            feasible = jnp.min(c) > 0
            w = jnp.where(
                c > 0, jnp.minimum(y / jnp.where(c > 0, c, 1.0), ratio_cap), 0.0
            )
            lag_hvp = problem.lag_rhess_at(x, y)  # TRUE y in the Lagrangian
            gx = problem.gx_at(x)
            gx_adj = problem.gx_adj_at(x)

            def hw(dx):
                lag = lag_hvp(dx)
                bar = gx(w * gx_adj(dx))
                return jax.tree.map(lambda a, b: a + b, lag, bar)

            cx = problem.rgrad(x)
        # Deterministic start (no RNG in the solver path); the projected
        # all-ones direction keeps v0 nonzero when the gradient vanishes
        # (interior optimum).
        ones_t = man.proj(x, jax.tree.map(jnp.ones_like, x))
        v0 = jax.tree.map(lambda a, b: a + 0.1 * b, cx, ones_t)
        _, _, ritz = lanczos(hw, v0, lambda u, t: man.inner(x, u, t), k)
        return jnp.where(feasible, ritz[0], jnp.nan)

    return jax.jit(jax.vmap(one))(xs, ys)


def _as_stacked_points(xs0):
    """Lists stack into a batched array (convenience-wrapper behavior);
    tuples/dicts are pytree points (product manifolds) mapped leaf-wise."""
    if isinstance(xs0, list):
        return jnp.asarray(xs0)
    return jax.tree.map(jnp.asarray, xs0)


def run_sweep(problem, option, xs0, ys0, *, max_steps=2000, mesh=None, axis="dp"):
    """Convenience wrapper: sharded when a mesh is given, else vmapped."""
    xs0 = _as_stacked_points(xs0)
    ys0 = jnp.asarray(ys0)
    if mesh is None:
        fn = batched_riptrm_solve(problem, option, max_steps)
        states, ks, res = fn(xs0, ys0)
        return states.x, states.y, ks, res
    fn = sharded_riptrm_solve(problem, option, max_steps, mesh, axis)
    return fn(xs0, ys0)


def make_segment_solver(problem, option, segment_steps: int):
    """One checkpointable SEGMENT of a batched RIPTRM sweep.

    Returns a jitted fn (states, done) -> (states, ks, res, done) running at
    most ``segment_steps`` further inner steps per lane.  Lanes flagged
    ``done`` are frozen (their state passes through untouched, ks = 0);
    done-ness of the others comes from the compiled solve's own internal
    stop flag (NOT from k < segment_steps, which is ambiguous for a lane
    converging exactly on the segment's last step).  ``solve_compiled``
    resumes from any state (outer_iter / mu / trust region are all in the
    carry), so segments compose exactly.
    """
    solver = RIPTRM(_batched_exact_defaults(option))
    _warn_vmapped_lanczos(solver.option)
    solve = solver.solve_compiled(problem, segment_steps, return_done=True)

    def one(state, done):
        new_state, k, stopped = solve(state)
        out = jax.tree.map(
            lambda old, new: jnp.where(done, old, new), state, new_state
        )
        k = jnp.where(done, 0, k)
        res = compute_residual(problem, out.x, out.y, jnp.zeros((0,)))[0]
        new_done = done | stopped
        return out, k, res, new_done

    return jax.jit(jax.vmap(one))


def _sweep_identity(problem, option, xs0, ys0) -> str:
    """Fingerprint of a checkpointed sweep's inputs.

    A checkpoint resumed at the same path silently DISCARDS the caller's
    ``xs0``/``ys0``; if the path were reused for a different sweep whose
    state happens to have the same shapes, the wrong state would be resumed
    with no error.  Stamp the identity (initial points, non-callable solver
    options, problem dims) into the checkpoint meta and refuse to resume on
    mismatch.
    """
    import hashlib

    h = hashlib.sha256()
    for leaf in jax.tree.leaves(xs0) + jax.tree.leaves(ys0):
        arr = np.ascontiguousarray(np.asarray(leaf))
        h.update(str(arr.shape).encode())
        h.update(str(arr.dtype).encode())
        h.update(arr.tobytes())
    opts = {k: v for k, v in option.items() if not callable(v)}
    h.update(repr(sorted(opts.items(), key=lambda kv: kv[0])).encode())
    h.update(f"m={problem.num_ineq},dim={problem.manifold.dim}".encode())
    return h.hexdigest()[:16]


def run_sweep_checkpointed(
    problem,
    option,
    xs0,
    ys0,
    *,
    max_steps=2000,
    segment_steps=500,
    checkpoint_path=None,
    mesh=None,
    axis="dp",
    meta=None,
    on_segment=None,
):
    """Fault-tolerant batched sweep: the full batched solver state is
    checkpointed after every ``segment_steps``-step segment, and a rerun
    with the same ``checkpoint_path`` resumes from the last completed
    segment instead of restarting (the reference loses everything on a
    kill — its only persistence is the final Output, SURVEY §5
    "Checkpoint / resume: None").

    With ``mesh``, the batch axis is sharded over ``axis`` via
    ``NamedSharding`` and jit partitions each segment across the devices;
    checkpoints are written from the gathered host copy, so a resume may
    use a different device count than the crashed run.

    Returns (x_final, y_final, total_steps, residuals).
    ``on_segment(segment_idx, total_steps, res, done)`` is an optional host
    callback after each segment (progress logging).
    """
    from riptrm_tpu.experiment.checkpoint import load_state, save_state

    xs0 = _as_stacked_points(xs0)  # pytree points map; lists stack
    ys0 = jnp.asarray(ys0)
    solver = RIPTRM(_batched_exact_defaults(option))
    batch = ys0.shape[0]

    states0 = jax.vmap(
        lambda x0, y0: init_state_from(problem, solver.option, x0, y0)
    )(xs0, ys0)
    carry0 = {
        "state": states0,
        "done": jnp.zeros((batch,), bool),
        "ks": jnp.zeros((batch,), jnp.int32),
    }

    sweep_id = _sweep_identity(problem, solver.option, xs0, ys0)
    carry, start_meta = carry0, {}
    if checkpoint_path is not None and os.path.exists(checkpoint_path):
        carry, start_meta = load_state(checkpoint_path, carry0)
        saved_id = start_meta.get("sweep_id")
        if saved_id is not None and saved_id != sweep_id:
            raise ValueError(
                f"checkpoint {checkpoint_path} was saved by a DIFFERENT sweep "
                f"(sweep_id {saved_id} != {sweep_id}): refusing to resume — "
                "the caller's xs0/ys0/option would be silently discarded. "
                "Use a fresh checkpoint_path (or delete the stale file)."
            )
        if saved_id is None:
            import warnings

            warnings.warn(
                f"resuming legacy checkpoint {checkpoint_path} with no sweep "
                "identity stamp: the caller's xs0/ys0 are ignored in favor of "
                "the checkpointed state.",
                stacklevel=2,
            )
    # Budget accounting rides on exact steps_done (recorded in the
    # checkpoint meta), so a resume may use a different segment_steps.
    steps_done = int(
        start_meta.get(
            "steps_done",
            # older checkpoints recorded only whole segments, at THEIR OWN
            # segment size (falling back to the current one, best effort)
            start_meta.get("segments_done", 0)
            * start_meta.get("segment_steps", segment_steps),
        )
    )
    n_seg = int(start_meta.get("segments_done", 0))

    if mesh is not None:
        from jax.sharding import NamedSharding

        # Every carry leaf is per-lane with the batch axis leading.
        carry = jax.device_put(
            carry,
            jax.tree.map(
                lambda leaf: NamedSharding(
                    mesh, P(axis, *([None] * (jnp.ndim(leaf) - 1)))
                ),
                carry,
            ),
        )

    # The final segment is truncated so max_steps is exact, not rounded up
    # to a segment boundary; at most two distinct lengths compile.
    segments = {}

    def seg_fn(length):
        if length not in segments:
            segments[length] = make_segment_solver(problem, option, length)
        return segments[length]

    res = None
    while steps_done < max_steps and not bool(jnp.all(carry["done"])):
        length = min(segment_steps, max_steps - steps_done)
        states, ks, res, done = seg_fn(length)(carry["state"], carry["done"])
        carry = {"state": states, "done": done, "ks": carry["ks"] + ks}
        steps_done += length
        n_seg += 1
        if checkpoint_path is not None:
            save_state(
                checkpoint_path,
                jax.device_get(carry),
                dict(
                    meta or {},
                    segments_done=n_seg,
                    steps_done=steps_done,
                    sweep_id=sweep_id,
                ),
            )
        if on_segment is not None:
            on_segment(n_seg, steps_done, np.asarray(res), np.asarray(done))

    if res is None:  # resumed already-finished (or zero-budget) sweep
        res = jax.jit(
            jax.vmap(
                lambda st: compute_residual(
                    problem, st.x, st.y, jnp.zeros((0,))
                )[0]
            )
        )(carry["state"])
    st = carry["state"]
    return st.x, st.y, carry["ks"], res
