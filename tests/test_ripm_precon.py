"""RIPM Jacobi-Theta preconditioned condensed CR.

The preconditioner must change ONLY the Krylov inner solve, not the
Newton fixed point: at tight Krylov tolerance the preconditioned and
unpreconditioned steps from the same state must agree, and the
preconditioned full solve must reach the same residual class.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from riptrm_tpu.experiment.chip_sweep import build_sweep
from riptrm_tpu.solvers import ripm


def _problem(d=3, seed=3):
    problem, xs0, ys0 = build_sweep("StableIdentification", d, 1, seed=seed)
    # x64 coordinates for a clean fixed-point comparison
    x0 = tuple(jnp.asarray(leaf[0], jnp.float64) for leaf in xs0)
    y0 = jnp.asarray(ys0[0], jnp.float64)
    from riptrm_tpu.problems import stable_identification as si
    # rebuild at f64 via the problem's own data (build_sweep made f32)
    return problem, x0, y0


def _start_state(problem, x0, y0, opt):
    """f64 RipmState from (x0, y0) — mirrors _solver_plumbing's start."""
    m = problem.num_ineq
    f = ripm._kkt_field(problem, x0, jnp.zeros((0,), y0.dtype), y0, y0)
    phi0 = ripm._phi(problem, x0, *f)
    st0 = ripm.RipmState(
        x=x0, y=jnp.zeros((0,), y0.dtype), z=y0, s=y0, phi=phi0,
        sigma=jnp.minimum(0.5, phi0**0.25),
        rho=jnp.vdot(y0, y0) / m,
        gamma=jnp.asarray(opt["gamma"], y0.dtype),
        iteration=jnp.asarray(0),
    )
    tau_1 = jnp.min(y0 * y0) * m / jnp.vdot(y0, y0)
    tau_2 = jnp.vdot(y0, y0) / jnp.sqrt(phi0)
    return st0, tau_1, tau_2


def _step_dir(problem, x0, y0, option):
    opt = ripm.RIPM(option).option
    st0, tau_1, tau_2 = _start_state(problem, x0, y0, opt)
    step = ripm.make_step(problem, opt)
    new_st, info = step(st0, tau_1, tau_2)
    return new_st, info


def test_preconditioned_step_matches_unpreconditioned():
    problem, x0, y0 = _problem()
    base = {
        "KrylovIterMethod": True,
        "KrylovTolrelresid": 1e-12,
        "KrylovMaxIteration": 3000,
    }
    st_plain, info_plain = _step_dir(problem, x0, y0, dict(base))
    st_pre, info_pre = _step_dir(
        problem, x0, y0, dict(base, KrylovPreconditioner="jacobi_theta")
    )
    for a, b in zip(jax.tree.leaves(st_plain.x), jax.tree.leaves(st_pre.x)):
        np.testing.assert_allclose(np.asarray(a), np.asarray(b),
                                   rtol=1e-6, atol=1e-8)
    np.testing.assert_allclose(
        float(st_plain.phi), float(st_pre.phi), rtol=1e-5
    )


def test_preconditioner_reduces_cr_iterations():
    """On an ill-conditioned condensed system (late-barrier z/s spread)
    the Jacobi-Theta scaling must not need MORE iterations than plain CR
    to the same relative residual; on the well-conditioned start it
    should be comparable."""
    problem, x0, y0 = _problem()
    # a z/s spread like a late barrier iterate: widely scaled multipliers
    rng = np.random.default_rng(0)
    z0 = jnp.asarray(10.0 ** rng.uniform(-4, 2, size=y0.shape), y0.dtype)
    base = {
        "KrylovIterMethod": True,
        "KrylovTolrelresid": 1e-10,
        "KrylovMaxIteration": 3000,
    }
    _, info_plain = _step_dir(problem, x0, z0, dict(base))
    _, info_pre = _step_dir(
        problem, x0, z0, dict(base, KrylovPreconditioner="jacobi_theta")
    )
    it_plain = int(info_plain["KrylovIterMethod_Iter"])
    it_pre = int(info_pre["KrylovIterMethod_Iter"])
    assert it_pre <= it_plain, (it_pre, it_plain)


def test_preconditioned_solve_converges():
    """Sanity: the preconditioned compiled solve makes solid progress on a
    small instance (RIPM on StableIdentification converges slowly for
    every variant — plain CR reaches ~1.5e-4 in 500 steps on this
    instance — so this asserts the residual class, not deep tolerance;
    the d=32 A/B lives in the chip/CPU measurement harnesses)."""
    problem, x0, y0 = _problem()
    option = {
        "maxiter": 200,
        "tolresid": 1e-6,
        "KrylovIterMethod": True,
        "KrylovMaxIteration": 500,
        "KrylovPreconditioner": "jacobi_theta",
    }
    solve = ripm.solve_compiled_best(problem, option, 200)
    opt = ripm.RIPM(option).option
    st0, tau_1, tau_2 = _start_state(problem, x0, y0, opt)
    st, k, best = jax.jit(lambda s, t1, t2: solve(s, t1, t2, -jnp.inf))(
        st0, tau_1, tau_2
    )
    start_res = 56.0  # class of the instance's initial KKT residual
    assert float(best) < 1e-2, float(best)
    assert float(best) < start_res / 1e3


def test_precon_rejects_equality_constraints():
    from riptrm_tpu.problems.problem import Problem
    from riptrm_tpu.manifolds import Sphere

    man = Sphere(4)
    x0 = jnp.ones((4,)) / 2.0
    problem = Problem(
        manifold=man,
        cost=lambda x: jnp.sum(x**2 * jnp.arange(4.0)),
        ineq=lambda x: -x,
        eq=lambda x: jnp.sum(x)[None] - 1.0,
        x0=x0,
        y0=jnp.ones((4,)),
        z0=jnp.zeros((1,)),
        num_ineq=4,
        num_eq=1,
    )
    option = ripm.RIPM({
        "KrylovIterMethod": True,
        "KrylovPreconditioner": "jacobi_theta",
    }).option
    with pytest.raises(NotImplementedError):
        ripm.make_step(problem, option)(
            *ripm.init_state(problem, option)
        )


def test_staged_precision_ripm_solve():
    """The two-phase RIPM continuation composes and does not hand back a
    state worse than phase 1 (keep_best continuation semantics)."""
    from riptrm_tpu.parallel.sweep import staged_precision_ripm_solve
    from riptrm_tpu.problems import stable_identification as si
    from riptrm_tpu.experiment.chip_sweep import (
        _cache_load, _generate_payload,
    )

    payload = _cache_load("StableIdentification", 3, 2, 11) or \
        _generate_payload("StableIdentification", 3, 2, 11)
    starts = (payload["b_J"], payload["b_R"], payload["b_Q"])
    problem_lo = si.make_problem(
        3, list(payload["trajs"]), payload["constset"],
        tuple(a[0] for a in starts), dtype=jnp.float32,
    )
    problem_hi = si.make_problem(
        3, list(payload["trajs"]), payload["constset"],
        tuple(a[0] for a in starts), dtype=jnp.float32,
        matmul_precision="highest",
    )
    option_lo = {"maxiter": 60, "tolresid": 1e-3, "KrylovIterMethod": True,
                 "KrylovMaxIteration": 200}
    option_hi = {"maxiter": 60, "tolresid": 1e-5, "KrylovIterMethod": True,
                 "KrylovMaxIteration": 200,
                 "KrylovPreconditioner": "jacobi_theta"}
    staged = staged_precision_ripm_solve(
        problem_lo, problem_hi, option_lo, option_hi, 60
    )
    xs0 = tuple(jnp.asarray(a, jnp.float32) for a in starts)
    ys0 = jnp.ones((2, problem_lo.num_ineq), jnp.float32)
    st2, ks, res2, res1 = staged(xs0, ys0)
    assert res1.shape == (2,) and res2.shape == (2,)
    r1, r2 = np.asarray(res1), np.asarray(res2)
    # keep_best continuation: phase 2 never ends above its own start
    assert np.all(r2 <= r1 * (1.0 + 1e-4)), (r1, r2)
