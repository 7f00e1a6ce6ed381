"""Solver-level regression tests on the shipped golden datasets
(SURVEY.md §4: deterministic inputs are the golden fixtures)."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from riptrm_tpu.ops.kkt import compute_residual
from riptrm_tpu.problems import nonneg_pca
from riptrm_tpu.solvers.ralm import RALM
from riptrm_tpu.solvers.ripm import RIPM
from riptrm_tpu.solvers.riptrm import RIPTRM, init_state
from riptrm_tpu.solvers.rsqo import RSQO

OPT_COMMON = {"maxtime": 120, "maxiter": 30, "verbosity": 0}


@pytest.fixture(scope="module")
def pca():
    return nonneg_pca.load_problem("dataset/NonnegPCA/1", "a")


def _final_residual(out):
    return out.log["residual"][-1]


class TestRIPTRM:
    def test_tcg_converges(self, pca):
        out = RIPTRM(
            OPT_COMMON | {"tolresid": 1e-8, "TRS_solver": "tCG", "second_order_stationarity": False}
        ).run(pca)
        assert _final_residual(out) <= 1e-8
        x = np.asarray(out.x)
        assert abs(np.linalg.norm(x) - 1) < 1e-12  # on-sphere
        assert x.min() > -1e-12  # feasible
        assert np.asarray(out.ineqLagmult).min() > 0  # dual feasible
        # optimum value regression (shared across all four solvers)
        assert out.log["cost"][-1] == pytest.approx(-1.537809, abs=1e-4)

    def test_exact_second_order_converges(self, pca):
        out = RIPTRM(
            OPT_COMMON
            | {"tolresid": 1e-6, "TRS_solver": "Exact_RepMat", "second_order_stationarity": True}
        ).run(pca)
        assert _final_residual(out) <= 1e-6
        # second-order certificate: last logged min eig of Hw nonnegative-ish
        mineigs = [v for v in out.log["mineigvalHw"] if v is not None]
        assert mineigs[-1] > -1e-6

    def test_tcg_second_order_lanczos(self, pca):
        """Matrix-free second-order certificate: tCG mode + Lanczos Ritz
        minimum of Hw (no dense basis materialization)."""
        out = RIPTRM(
            OPT_COMMON
            | {"tolresid": 1e-6, "TRS_solver": "tCG", "second_order_stationarity": True}
        ).run(pca)
        assert _final_residual(out) <= 1e-6
        mineigs = [
            v for v in out.log["mineigvalHw"]
            if v is not None and np.isfinite(v)
        ]
        assert mineigs, "no inner step ever evaluated the Lanczos certificate"
        assert mineigs[-1] > -1e-6
        assert out.log["cost"][-1] == pytest.approx(-1.537809, abs=1e-4)

    def test_compiled_matches_host(self, pca):
        opt = {"maxiter": 40, "tolresid": 1e-9, "TRS_solver": "tCG", "second_order_stationarity": False}
        solver = RIPTRM(OPT_COMMON | opt)
        solve = jax.jit(solver.solve_compiled(pca, max_steps=600))
        state, k = solve(init_state(pca, solver.option))
        res = float(compute_residual(pca, state.x, state.y, jnp.zeros((0,)))[0])
        assert res <= 1e-9

    def test_barrier_schedule(self, pca):
        out = RIPTRM(
            OPT_COMMON | {"maxiter": 4, "tolresid": 0, "TRS_solver": "tCG", "second_order_stationarity": False}
        ).run(pca)
        mus = sorted(set(out.log["mu"][1:]), reverse=True)
        # mu follows max(1e-15, 0.5 * mu^1.01) from 0.1
        expected = [0.1]
        for _ in range(3):
            expected.append(max(1e-15, 0.5 * expected[-1] ** 1.01))
        np.testing.assert_allclose(mus[: len(expected)], expected, rtol=1e-12)


class TestRIPM:
    def test_converges_with_nt_check(self, pca):
        out = RIPM(OPT_COMMON | {"tolresid": 1e-6, "checkNTequation": True}).run(pca)
        assert _final_residual(out) <= 1e-6
        errs = [v for v in out.log["NTdir_error1"] if v is not None]
        assert max(errs) < 1e-10  # Newton system solved exactly
        assert out.log["cost"][-1] == pytest.approx(-1.537809, abs=1e-4)

    def test_krylov_mode(self, pca):
        out = RIPM(
            OPT_COMMON | {"tolresid": 1e-6, "KrylovIterMethod": True}
        ).run(pca)
        assert _final_residual(out) <= 1e-6


class TestRSQO:
    def test_converges(self, pca):
        out = RSQO(OPT_COMMON | {"tolresid": 1e-8, "quadoptim_eigvalcorr": 1e-2}).run(pca)
        assert _final_residual(out) <= 1e-8
        assert out.log["cost"][-1] == pytest.approx(-1.537809, abs=1e-4)

    def test_converges_schulz_qp(self, pca):
        """The factorization-free QP linear solve (quadoptim_linear_solver=
        'schulz', the batch-scaling matmul path) must reach the same
        optimum at the same depth as the Cholesky path on the golden
        instance."""
        out = RSQO(
            OPT_COMMON
            | {
                "tolresid": 1e-8,
                "quadoptim_eigvalcorr": 1e-2,
                "quadoptim_linear_solver": "schulz",
            }
        ).run(pca)
        assert _final_residual(out) <= 1e-8
        assert out.log["cost"][-1] == pytest.approx(-1.537809, abs=1e-4)


class TestRALM:
    def test_reaches_stationarity(self, pca):
        out = RALM(OPT_COMMON | {"maxiter": 15, "tolresid": 1e-4}).run(pca)
        assert min(out.log["residual"]) <= 1e-3
        assert out.log["cost"][-1] == pytest.approx(-1.537809, abs=1e-3)

    def test_unbounded_multipliers(self, pca):
        out = RALM(
            OPT_COMMON | {"maxiter": 8, "tolresid": 1e-4, "LagmultUnbdUpdate": True}
        ).run(pca)
        assert np.isfinite(out.log["residual"][-1])


def test_all_solvers_agree_on_optimum(pca):
    """Cross-solver consistency: same optimum from four different methods."""
    costs = []
    for solver in (
        RIPTRM(OPT_COMMON | {"maxiter": 20, "tolresid": 1e-7, "TRS_solver": "tCG", "second_order_stationarity": False}),
        RIPM(OPT_COMMON | {"maxiter": 25, "tolresid": 1e-7}),
        RSQO(OPT_COMMON | {"maxiter": 15, "tolresid": 1e-7, "quadoptim_eigvalcorr": 1e-2}),
    ):
        out = solver.run(pca)
        costs.append(out.log["cost"][-1])
    assert max(costs) - min(costs) < 1e-5


def test_check_trs_optimality_log_saves(pca, tmp_path):
    """checkTRSoptimality adds TRS_* keys only from iteration 1 on; the log
    must still save as a rectangular CSV (regression: LogAccumulator
    produced ragged columns and pd.DataFrame raised at save time)."""
    import pandas as pd

    out = RIPTRM(
        OPT_COMMON
        | {
            "tolresid": 1e-6,
            "maxiter": 5,
            "TRS_solver": "Exact_RepMat",
            "second_order_stationarity": False,
            "checkTRSoptimality": True,
        }
    ).run(pca)
    lengths = {k: len(v) for k, v in out.log.items()}
    assert len(set(lengths.values())) == 1, lengths
    df = pd.DataFrame(out.log)  # what simulator.save_output does
    assert "TRS_mineig" in df.columns
    assert df["TRS_mineig"].iloc[0] is None or np.isnan(df["TRS_mineig"].iloc[0])
    assert np.isfinite(df["TRS_mineig"].iloc[-1])


def test_inner_maxiter_reset_semantics():
    """Forced inner exits (inner_maxiter budget, RIPTRM.py:835-842) reset
    to the inner loop's initial point and still advance the outer loop;
    the solve makes progress across outer iterations (each restarts from
    the last ACCEPTED outer point, with mu decreasing)."""
    import jax
    import jax.numpy as jnp
    import numpy as np

    from riptrm_tpu.problems import nonneg_pca
    from riptrm_tpu.solvers.riptrm import RIPTRM, init_state

    k1, k2 = jax.random.split(jax.random.PRNGKey(0))
    data = nonneg_pca.generate_instance(k1, 12)
    x0 = np.abs(np.asarray(jax.random.normal(k2, (12,))))
    x0 /= np.linalg.norm(x0)
    problem = nonneg_pca.make_problem(data["Z"], x0)

    option = {
        "maxiter": 60,
        "tolresid": 1e-6,
        "inner_maxiter": 2,  # far too small: most inner runs get forced
        "TRS_solver": "tCG",
        "second_order_stationarity": False,
    }
    solver = RIPTRM(option)
    solve = jax.jit(solver.solve_compiled(problem, max_steps=400))
    st, k = solve(init_state(problem, solver.option))
    # mu advanced through outer iterations despite the forced resets
    assert int(st.outer_iter) > 5
    assert float(st.mu) < solver.option["initial_barrier_parameter"]
    # iterate stayed on-manifold and feasible throughout
    assert abs(np.linalg.norm(np.asarray(st.x)) - 1) < 1e-10
    assert np.asarray(st.x).min() > 0


def test_ripm_singular_newton_exits_gracefully():
    """A singular condensed system must not NaN-poison the state and burn
    the budget: the XLA solve yields non-finite directions silently, the
    step freezes the state and flags ``singular_newton``, and the host
    runner exits with logs preserved (reference exits on LinAlgError,
    ``RIPM.py:764-769``)."""
    import jax.numpy as jnp
    import numpy as np

    from riptrm_tpu.manifolds.euclidean import Euclidean
    from riptrm_tpu.problems.problem import Problem
    from riptrm_tpu.solvers.ripm import RIPM

    # cost Hessian = diag(0, 2); the single constraint only touches x[1],
    # so Aw = HessLag + Theta is singular in coordinate 0 at any point.
    problem = Problem(
        manifold=Euclidean(2),
        cost=lambda x: x[1] ** 2,
        ineq=lambda x: jnp.asarray([-x[1] - 1.0]),
        x0=jnp.asarray([0.5, 0.5]),
        y0=jnp.asarray([1.0]),
        z0=jnp.zeros((0,)),
        num_ineq=1,
        num_eq=0,
    )
    out = RIPM({"maxtime": 60, "maxiter": 25, "tolresid": 1e-12}).run(problem)
    solver_opt = out.option
    assert "Singular Newton" in solver_opt["stoppingcriterion"]
    # state never NaN-poisoned; every logged row is finite
    assert np.all(np.isfinite(np.asarray(out.x)))
    res = np.asarray(out.log["residual"], dtype=float)
    assert np.all(np.isfinite(res))
    # the flagged iteration is in the log for diagnosis
    assert out.log["singular_newton"][-1] in (True, 1)
