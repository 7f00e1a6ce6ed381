"""Bounded-coordinate PCA on Stiefel: all four solvers, incl. the dense
exact/second-order path (St(n,p) has a closed-form basis)."""

import pathlib

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from riptrm_tpu.problems import bounded_pca
from riptrm_tpu.solvers.ralm import RALM
from riptrm_tpu.solvers.ripm import RIPM
from riptrm_tpu.solvers.riptrm import RIPTRM
from riptrm_tpu.solvers.rsqo import RSQO

REPO_ROOT = pathlib.Path(__file__).resolve().parents[1]

N, P, BOUND = 16, 2, 0.6

OPT = {"maxtime": 120, "maxiter": 40, "verbosity": 0}


@pytest.fixture(scope="module")
def prob():
    inst = bounded_pca.generate_instance(jax.random.PRNGKey(5), N, snr=2.0)
    x0 = bounded_pca.generate_initialpoint(jax.random.PRNGKey(6), N, P, bound=BOUND)
    return bounded_pca.make_problem(inst["Z"], x0, bound=BOUND)


def _check_solution(out, tol=1e-7):
    x = np.asarray(out.x)
    assert np.abs(x.T @ x - np.eye(P)).max() < 1e-8  # on St(n,p)
    assert np.abs(x).max() <= BOUND + 1e-7  # feasible
    return x


class TestBoundedPCA:
    def test_initial_point_strictly_feasible(self, prob):
        assert float(jnp.min(prob.slack(prob.x0))) > 0.01

    def test_riptrm_tcg(self, prob):
        out = RIPTRM(
            OPT | {"tolresid": 1e-8, "TRS_solver": "tCG", "second_order_stationarity": False}
        ).run(prob)
        assert out.log["residual"][-1] <= 1e-8
        _check_solution(out)

    def test_riptrm_exact_second_order(self, prob):
        out = RIPTRM(
            OPT | {"tolresid": 1e-6, "TRS_solver": "Exact_RepMat", "second_order_stationarity": True}
        ).run(prob)
        assert out.log["residual"][-1] <= 1e-6
        mineigs = [v for v in out.log["mineigvalHw"] if v is not None]
        assert mineigs[-1] > -1e-6
        _check_solution(out)

    def test_bound_constraints_active_when_tight(self):
        """With a tight bound the optimum must sit on the box boundary
        (otherwise the problem reduces to plain PCA)."""
        inst = bounded_pca.generate_instance(jax.random.PRNGKey(7), N, snr=4.0, delta=0.2)
        b = 0.45
        x0 = bounded_pca.generate_initialpoint(jax.random.PRNGKey(8), N, P, bound=b)
        p = bounded_pca.make_problem(inst["Z"], x0, bound=b)
        out = RIPTRM(
            OPT | {"tolresid": 1e-7, "TRS_solver": "tCG", "second_order_stationarity": False}
        ).run(p)
        assert out.log["residual"][-1] <= 1e-7
        x = np.asarray(out.x)
        # the spiked leading eigenvector is localized (delta=0.2), so the
        # bound binds: some |x_ij| is at b
        assert np.abs(x).max() > b - 1e-5

    def test_rsqo(self, prob):
        out = RSQO(OPT | {"tolresid": 1e-7, "quadoptim_eigvalcorr": 1e-2}).run(prob)
        assert out.log["residual"][-1] <= 1e-7
        _check_solution(out)

    def test_ripm_krylov(self, prob):
        """RIPM's merit Phi = ||F||^2 has non-KKT local minima on nonconvex
        instances (its documented fragility; it also degenerates on the
        reference's Rosenbrock and StableIdentification).  On the
        Brockett-weighted default it may stall, so: (a) RIPM must CONVERGE
        on the gauge-symmetric variant (weights = 1, where the
        perturbed-KKT field is better behaved for this instance), and
        (b) on the weighted default it must terminate with finite logged
        state, never NaN-poisoned."""
        inst = bounded_pca.generate_instance(jax.random.PRNGKey(5), N, snr=2.0)
        x0 = bounded_pca.generate_initialpoint(jax.random.PRNGKey(6), N, P, bound=BOUND)
        gauge = bounded_pca.make_problem(
            inst["Z"], x0, bound=BOUND, weights=[1.0] * P
        )
        out = RIPM(OPT | {"tolresid": 1e-6, "KrylovIterMethod": True}).run(gauge)
        assert out.log["residual"][-1] <= 1e-6

        out_w = RIPM(
            OPT | {"tolresid": 1e-6, "KrylovIterMethod": True, "maxiter": 15}
        ).run(prob)
        res_w = np.asarray(out_w.log["residual"], dtype=float)
        assert np.all(np.isfinite(res_w))
        assert np.all(np.isfinite(np.asarray(out_w.x)))

    def test_ralm(self, prob):
        out = RALM(OPT | {"maxiter": 20, "tolresid": 1e-4}).run(prob)
        assert min(out.log["residual"]) < 1e-2

    def test_solvers_agree_on_cost(self, prob):
        costs = []
        for s in (
            RIPTRM(OPT | {"tolresid": 1e-7, "TRS_solver": "tCG", "second_order_stationarity": False}),
            RSQO(OPT | {"tolresid": 1e-7, "quadoptim_eigvalcorr": 1e-2}),
        ):
            costs.append(s.run(prob).log["cost"][-1])
        assert abs(costs[0] - costs[1]) < 1e-5


def test_batched_multistart_sweep(prob):
    """Multi-start sweep on a matrix manifold as ONE vmapped compiled solve
    (the sweep axis vmaps over stacked [B, n, p] points)."""
    from riptrm_tpu.parallel.sweep import batched_riptrm_solve

    B = 4
    xs0 = jnp.stack(
        [
            jnp.asarray(
                bounded_pca.generate_initialpoint(jax.random.PRNGKey(20 + i), N, P, bound=BOUND)
            )
            for i in range(B)
        ]
    )
    ys0 = jnp.ones((B, 2 * N * P), dtype=xs0.dtype)
    opt = {"maxiter": 40, "tolresid": 1e-7, "TRS_solver": "tCG",
           "second_order_stationarity": False, "verbosity": 0}
    solve = batched_riptrm_solve(prob, opt, max_steps=800)
    states, ks, res = solve(xs0, ys0)
    assert np.asarray(res).shape == (B,)
    assert np.max(np.asarray(res)) <= 1e-7
    # every lane on-manifold
    xs = np.asarray(states.x)
    for i in range(B):
        assert np.abs(xs[i].T @ xs[i] - np.eye(P)).max() < 1e-8


def test_generate_and_load_roundtrip(tmp_path, monkeypatch):
    monkeypatch.chdir(REPO_ROOT)
    from riptrm_tpu.experiment.generate import main

    out = str(tmp_path / "ds")
    main(["--problem", "BoundedPCA", "dim=12", "p=2", f"output_path={out}"])
    p = bounded_pca.load_problem(out, "a")
    assert p.num_ineq == 2 * 12 * 2
    assert (np.asarray(p.slack(p.x0)) > 0).all()
