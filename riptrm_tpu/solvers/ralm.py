"""RALM: Riemannian Augmented Lagrangian Method (Liu-Boumal baseline).

Parity target: ``/root/reference/src/solver/RALM.py``:

* AL function / gradient closures       RALM.py:144-163 (here: stacked + AD)
* inner solve via steepest descent / CG RALM.py:180-188
* clipped multiplier + rho updates      RALM.py:205-228
* unbounded AKKT multiplier variant     RALM.py:193-203 (Yamakawa-Sato)

The AL gradient is exact AD of the AL cost (max(0, .)^2 is C^1), so the
stacked form needs no per-constraint loops; the entire outer step (inner
while_loop solve + multiplier updates) is one jitted function.
"""

from __future__ import annotations

import copy
from typing import NamedTuple

import jax
import jax.numpy as jnp

from riptrm_tpu.ops.kkt import evaluation
from riptrm_tpu.solvers.base import (
    Output,
    host_run,
    max_abs_multiplier,
    maybe_wandb_finish,
    maybe_wandb_init,
    merge_options,
)
from riptrm_tpu.solvers.subsolvers import conjugate_gradient, steepest_descent


def default_option():
    """Defaults mirroring ``RALM.py:22-57``."""
    return {
        "maxtime": 100,
        "maxiter": 100,
        "tolresid": 1e-6,
        "rho": 1.0,
        "bound": 20.0,
        "tau": 0.8,
        "thetarho": 0.3,
        "numOuterItertgn": 30,
        "LagmultUnbdUpdate": False,
        "innersubsolver": "SteepestDescent",  # or "ConjugateGradient"
        "maxInnerIter": 200,
        "startingtolgradnorm": 1e-3,
        "endingtolgradnorm": 1e-6,
        "innerminstepsize": 1e-10,
        # The reference computes the geometric inner-tolerance decay but
        # never persists it (RALM.py:140 re-reads startingtolgradnorm every
        # step; :228's decayed value is a discarded local), so its inner
        # solves always run at startingtolgradnorm.  False reproduces that
        # behavior; True enables the decay the algorithm intends.
        "tolgradnorm_decay_fix": False,
        # Compiled sweeps return the BEST iterate (see solve_compiled_best);
        # the host .run() path logs every step and is unaffected.
        "keep_best_point": True,
        "verbosity": 0,
        "wandb_logging": False,
        "do_exit_on_error": True,
    }


class RalmState(NamedTuple):
    x: object
    y: jnp.ndarray  # clipped inequality multipliers
    z: jnp.ndarray  # clipped equality multipliers
    y_unbd: jnp.ndarray
    z_unbd: jnp.ndarray
    rho: jnp.ndarray
    oldacc: jnp.ndarray
    tolgradnorm: jnp.ndarray
    outer_iter: jnp.ndarray


def make_step(problem, option):
    man = problem.manifold
    bound = option["bound"]
    tau = option["tau"]
    thetarho = option["thetarho"]
    ending = option["endingtolgradnorm"]
    theta_tol = (option["endingtolgradnorm"] / option["startingtolgradnorm"]) ** (
        1.0 / option["numOuterItertgn"]
    )
    subsolver = (
        steepest_descent
        if option["innersubsolver"] == "SteepestDescent"
        else conjugate_gradient
    )

    def _al_terms(val, g, h, y, z, rho):
        """AL function formula (RALM.py:144-153)."""
        if g is not None:
            val = val + 0.5 * rho * jnp.sum(jnp.maximum(0.0, y / rho + g) ** 2)
        if h is not None:
            val = val + 0.5 * rho * jnp.sum((z / rho + h) ** 2)
        return val

    # Embedded problems (fixed-rank): differentiate the AL in the AMBIENT
    # space so egrad2rgrad receives an ambient matrix, not a gradient with
    # respect to the factored (U, S, V) representation.
    embedded = getattr(problem, "a_cost", None) is not None

    def al_cost(x, y, z, rho):
        return _al_terms(
            problem.cost(x),
            problem.ineq(x) if problem.has_ineq else None,
            problem.eq(x) if problem.has_eq else None,
            y, z, rho,
        )

    def al_ambient(xa, y, z, rho):
        return _al_terms(
            problem.a_cost(xa),
            problem.a_ineq(xa) if problem.has_ineq else None,
            problem.a_eq(xa) if problem.has_eq else None,
            y, z, rho,
        )

    decay_fix = option["tolgradnorm_decay_fix"]

    def step(state: RalmState):
        y, z, rho = state.y, state.z, state.rho

        cost = lambda x: al_cost(x, y, z, rho)
        if embedded:
            rgrad = lambda x: man.egrad2rgrad(
                x, jax.grad(al_ambient)(man.embed_point(x), y, z, rho)
            )
        else:
            rgrad = lambda x: man.egrad2rgrad(x, jax.grad(cost)(x))
        inner_tol = (
            state.tolgradnorm
            if decay_fix
            else jnp.asarray(option["startingtolgradnorm"], dtype=rho.dtype)
        )
        result = subsolver(
            man,
            cost,
            rgrad,
            state.x,
            max_iterations=option["maxInnerIter"],
            min_step_size=option["innerminstepsize"],
            min_gradient_norm=inner_tol,
        )
        x = result.point

        g = problem.ineq_val(x)
        h = problem.eq_val(x)

        # Unbounded AKKT multipliers (RALM.py:193-203)
        y_unbd = jnp.maximum(0.0, y + rho * g) if problem.has_ineq else state.y_unbd
        z_unbd = z + rho * h if problem.has_eq else state.z_unbd

        # Clipped multiplier updates + accuracy (RALM.py:205-218)
        newacc = jnp.asarray(0.0, dtype=rho.dtype)
        if problem.has_ineq:
            newacc = jnp.maximum(newacc, jnp.max(jnp.abs(jnp.maximum(-y / rho, g))))
            y = jnp.minimum(bound, jnp.maximum(0.0, y + rho * g))
        if problem.has_eq:
            newacc = jnp.maximum(newacc, jnp.max(jnp.abs(h)))
            z = jnp.minimum(bound, jnp.maximum(-bound, z + rho * h))

        # rho update (RALM.py:225-227).  The reference's 'OuterIteration == 0'
        # branch can never fire (run() increments before calling step, so the
        # argument is always >= 1); only the accuracy test remains.  With
        # oldacc = inf initially, the first step never increases rho.
        rho = jnp.where(newacc > tau * state.oldacc, rho / thetarho, rho)
        tolgradnorm = jnp.maximum(ending, state.tolgradnorm * theta_tol)

        new_state = RalmState(
            x=x,
            y=y,
            z=z,
            y_unbd=y_unbd,
            z_unbd=z_unbd,
            rho=rho,
            oldacc=newacc,
            tolgradnorm=tolgradnorm,
            outer_iter=state.outer_iter + 1,
        )
        info = {
            "inner_iterations": result.iterations,
            "inner_gradnorm": result.gradient_norm,
        }
        return new_state, info

    return step


def eval_multipliers(problem, state, option):
    """``set_LagEvals`` (RALM.py:65-80)."""
    if option["LagmultUnbdUpdate"]:
        return state.y_unbd, state.z_unbd
    return state.y, state.z


def init_state(problem, option):
    y0 = jnp.asarray(problem.y0)
    z0 = jnp.asarray(problem.z0)
    dt = y0.dtype if y0.size else jnp.asarray(1.0).dtype
    return RalmState(
        x=problem.x0,
        y=y0,
        z=z0,
        y_unbd=y0,
        z_unbd=z0,
        rho=jnp.asarray(option["rho"], dtype=dt),
        oldacc=jnp.asarray(jnp.inf, dtype=dt),
        tolgradnorm=jnp.asarray(option["startingtolgradnorm"], dtype=dt),
        outer_iter=jnp.asarray(0),
    )


def solve_compiled_best(problem, option, max_steps: int):
    """Compiled RALM solve tracking min-KKT-residual-so-far (the protocol
    metric, seeded with the initial residual); stops early once
    ``best <= target``.  Returns solve(state, target) -> (state, steps,
    best).  The loop body is the shared ``compiled_best_while``;
    ``solve_compiled`` delegates with target = -inf.

    ``keep_best_point`` (default True): the returned state is the BEST
    iterate, not the last — RALM's KKT residual is non-monotone (the
    clipped-multiplier/rho updates overshoot past the dip; measured
    NonnegPCA: 3.96e-4 dip -> 0.69 final).  The reference's analyzer
    notebooks (``src/*/analyzer.ipynb``) plot the FULL residual
    trajectory, so the dip is what a reader scores there; best-iterate
    reporting matches that reading (the reference has no scalar
    best-within-budget metric — the attribution is to the trajectory
    plots, not an analyzer computation).  Final-state reporting misread
    RALM as "stalled at 0.62" in batched sweeps.  Set False for strict last-iterate semantics; sweep
    harnesses surface the choice as ``point="best"|"final"`` in their
    output rows."""
    from riptrm_tpu.ops.kkt import compute_residual
    from riptrm_tpu.solvers.base import compiled_best_while, merge_options

    option = merge_options(default_option(), option or {})
    step = make_step(problem, option)
    tolresid = option["tolresid"]
    maxiter = option["maxiter"]
    unbd = option["LagmultUnbdUpdate"]
    keep_best = option.get("keep_best_point", True)

    def residual(st):
        y_eval = st.y_unbd if unbd else st.y
        z_eval = st.z_unbd if unbd else st.z
        return compute_residual(problem, st.x, y_eval, z_eval)[0]

    def step1(st):
        new_st, _ = step(st)
        res = residual(new_st)
        return new_st, res, jnp.asarray(True), res <= tolresid

    def solve(state, target):
        st, k, _, best = compiled_best_while(
            step1, state, target, min(max_steps, maxiter), residual(state),
            stall_window=option.get("sweep_stall_window"),
            track_best_state=keep_best,
        )
        return st, k, best

    return solve


def solve_compiled(problem, option, max_steps: int):
    """Fully-compiled RALM solve for vmapped sweeps: solve(state) -> (state, steps)."""
    inner = solve_compiled_best(problem, option, max_steps)

    def solve(state):
        st, k, _ = inner(state, -jnp.inf)
        return st, k

    return solve


class RALM:
    def __init__(self, option=None):
        self.option = merge_options(default_option(), option or {})
        self.name = f"RALM_{self.option['innersubsolver']}"

    def run(self, problem) -> Output:
        option = self.option
        maybe_wandb_init(option, self.name)
        state = init_state(problem, option)
        # AOT-compile before the clock starts (compile is excluded time).
        step = jax.jit(make_step(problem, option)).lower(state).compile()
        y0e, z0e = eval_multipliers(problem, state, option)
        eval_jit = (
            jax.jit(lambda s, y, z, xp: evaluation(problem, xp, s.x, y, z))
            .lower(state, y0e, z0e, state.x)
            .compile()
        )

        def evaluate(x_prev, st):
            y_eval, z_eval = eval_multipliers(problem, st, option)
            return eval_jit(st, y_eval, z_eval, x_prev)

        def status_row(st, info):
            y_eval, z_eval = eval_multipliers(problem, st, option)
            return {
                "rho": st.rho,
                "maxabsLagmult": max_abs_multiplier(y_eval, z_eval),
            }

        state, log, stop_reason = host_run(
            name=self.name,
            option=option,
            state=state,
            step=step,
            evaluate=evaluate,
            status_row=status_row,
            get_x=lambda st: st.x,
            verbosity_line=lambda i, ev: (
                f"Iter: {i}, Cost: {float(ev['cost'])}, KKT residual: {float(ev['residual'])}"
            ),
        )

        self.option["stoppingcriterion"] = stop_reason
        maybe_wandb_finish(option)
        y_eval, z_eval = eval_multipliers(problem, state, option)
        opt_out = {k: v for k, v in self.option.items() if not callable(v)}
        return Output(
            name=self.name,
            x=state.x,
            ineqLagmult=y_eval,
            eqLagmult=z_eval,
            option=copy.deepcopy(opt_out),
            log=log,
        )
