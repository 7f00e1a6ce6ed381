"""Auxiliary subsystem tests: profiling timers, host sharding, QP edge
cases, analyzer CLI wiring."""

import json
import pathlib

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from riptrm_tpu.ops.qp import solve_qp
from riptrm_tpu.parallel.distributed import host_shard
from riptrm_tpu.utils.profiling import device_timer

REPO_ROOT = pathlib.Path(__file__).resolve().parents[1]


def test_device_timer():
    f = jax.jit(lambda x: x @ x)
    t = device_timer(f, jnp.ones((64, 64)), warmup=1, reps=3)
    assert 0 < t < 5.0


def test_host_shard_partition():
    items = list(range(10))
    shards = [host_shard(items, process_id=i, num=3) for i in range(3)]
    assert sorted(sum(shards, [])) == items
    assert all(len(s) in (3, 4) for s in shards)


def test_host_shard_single_process():
    assert host_shard([1, 2, 3]) == [1, 2, 3]


class TestQPEdgeCases:
    def test_equality_constrained(self):
        """QP with equality constraints (RSQO would hit this on problems
        with eq constraints)."""
        n = 6
        rng = np.random.default_rng(0)
        L = rng.normal(size=(n, n))
        Q = jnp.asarray(L @ L.T + np.eye(n))
        p = jnp.asarray(rng.normal(size=n))
        G = jnp.asarray(rng.normal(size=(4, n)))
        h = jnp.asarray(np.full(4, 10.0))  # inactive
        A = jnp.asarray(rng.normal(size=(2, n)))
        b = jnp.asarray(rng.normal(size=2))
        sol = solve_qp(Q, p, G, h, A, b)
        # KKT: equality feasibility + stationarity
        np.testing.assert_allclose(np.asarray(A @ sol.x - b), 0, atol=1e-7)
        grad = np.asarray(Q @ sol.x + p + G.T @ sol.z + A.T @ sol.y)
        assert np.linalg.norm(grad) < 1e-6

    def test_ill_conditioned(self):
        """alpha=1e7 Rosenbrock-style conditioning."""
        n = 8
        rng = np.random.default_rng(1)
        Q = jnp.asarray(np.diag(np.geomspace(1e-2, 1e7, n)))
        p = jnp.asarray(rng.normal(size=n) * 1e3)
        G = jnp.asarray(-np.eye(n))
        h = jnp.asarray(np.full(n, 0.01))  # x >= -0.01
        sol = solve_qp(Q, p, G, h)
        assert int(sol.status) == 0
        assert np.all(np.asarray(G @ sol.x - h) < 1e-7)

    @pytest.mark.parametrize("with_eq", [False, True])
    def test_lu_matches_chol(self, with_eq):
        """method='lu' (deep-parity path) and 'chol' (fast path) must agree
        to solver tolerance on a well-conditioned QP, with and without
        equality rows."""
        n = 7
        rng = np.random.default_rng(3)
        L = rng.normal(size=(n, n))
        Q = jnp.asarray(L @ L.T + np.eye(n))
        p = jnp.asarray(rng.normal(size=n))
        G = jnp.asarray(rng.normal(size=(5, n)))
        h = jnp.asarray(np.abs(rng.normal(size=5)) + 0.5)
        A = jnp.asarray(rng.normal(size=(2, n))) if with_eq else None
        b = jnp.asarray(rng.normal(size=2)) if with_eq else None
        s_c = solve_qp(Q, p, G, h, A, b, method="chol")
        s_l = solve_qp(Q, p, G, h, A, b, method="lu")
        assert int(s_c.status) == 0 and int(s_l.status) == 0
        np.testing.assert_allclose(
            np.asarray(s_c.x), np.asarray(s_l.x), atol=1e-7
        )
        np.testing.assert_allclose(
            np.asarray(s_c.z), np.asarray(s_l.z), atol=1e-6
        )

    def test_schulz_matches_chol(self):
        """method='schulz' (factorization-free Newton-Schulz inverse
        maintenance, the batch-scaling matmul path) must agree with 'chol'
        to solver tolerance on a moderately conditioned QP."""
        n, m = 30, 40
        rng = np.random.default_rng(7)
        L = rng.normal(size=(n, n))
        Q = jnp.asarray(L @ L.T + np.eye(n))
        p = jnp.asarray(rng.normal(size=n))
        G = jnp.asarray(rng.normal(size=(m, n)))
        h = jnp.asarray(np.abs(rng.normal(size=m)) + 0.5)
        kw = dict(abstol=1e-9, reltol=1e-9, feastol=1e-9)
        s_c = solve_qp(Q, p, G, h, method="chol", **kw)
        s_s = solve_qp(Q, p, G, h, method="schulz", **kw)
        assert int(s_c.status) == 0
        # schulz's accuracy ceiling is O(eps * cond(M)): at 1e-9-deep
        # tolerances the late-IPM barrier conditioning can trip the
        # freeze (status 2) — the contract is an honest near-solution,
        # not a burned budget.
        assert int(s_s.status) in (0, 2)
        np.testing.assert_allclose(
            np.asarray(s_s.x), np.asarray(s_c.x), atol=1e-5
        )
        assert float(s_s.gap) < 1e-4
        assert float(s_s.dual_infeasibility) < 1e-4
        assert s_s.xinv is not None and s_s.xinv.shape == (n, n)

    def test_schulz_warm_start_reuses_inverse(self):
        """Passing QpResult.xinv back as xinv0 (the SQP carry) must still
        converge to the same solution — and a garbage warm inverse must
        be survivable via the identity reset, not poison the solve."""
        n, m = 20, 25
        rng = np.random.default_rng(11)
        L = rng.normal(size=(n, n))
        Q = jnp.asarray(L @ L.T + np.eye(n))
        p = jnp.asarray(rng.normal(size=n))
        G = jnp.asarray(rng.normal(size=(m, n)))
        h = jnp.asarray(np.abs(rng.normal(size=m)) + 0.5)
        cold = solve_qp(Q, p, G, h, method="schulz")
        warm = solve_qp(Q, p, G, h, method="schulz", xinv0=cold.xinv)
        np.testing.assert_allclose(
            np.asarray(warm.x), np.asarray(cold.x), atol=1e-6
        )
        stale = solve_qp(
            Q, p, G, h, method="schulz", xinv0=1e6 * jnp.eye(n)
        )
        assert int(stale.status) in (0, 2)
        assert np.all(np.isfinite(np.asarray(stale.x)))

    def test_schulz_rejects_equality_constraints(self):
        n = 4
        with pytest.raises(ValueError, match="inequality-only"):
            solve_qp(
                jnp.eye(n), jnp.ones(n), -jnp.eye(n), jnp.ones(n),
                jnp.ones((1, n)), jnp.ones(1), method="schulz",
            )

    def test_nan_freeze_returns_last_finite_iterate(self):
        """A poisoned Newton system (here: NaN in Q) must freeze the lane
        at its last finite iterate with status 2 instead of burning the
        full maxiter and returning NaNs (the f32 batched-RSQO failure
        mode)."""
        n = 4
        Q = jnp.eye(n).at[0, 0].set(jnp.nan)
        p = jnp.ones((n,))
        G = -jnp.eye(n)
        h = jnp.ones((n,))
        sol = solve_qp(Q, p, G, h, maxiter=50)
        assert int(sol.status) == 2
        assert int(sol.iterations) == 1  # froze immediately, no burn
        assert np.isfinite(np.asarray(sol.x)).all()
        assert np.isfinite(np.asarray(sol.z)).all()

    def test_active_constraints_multipliers(self):
        """Binding constraint must yield a positive multiplier."""
        Q = jnp.eye(2)
        p = jnp.asarray([-10.0, 0.0])
        G = jnp.asarray([[1.0, 0.0]])
        h = jnp.asarray([1.0])  # x0 <= 1 binds (unconstrained optimum x0=10)
        sol = solve_qp(Q, p, G, h)
        assert float(sol.x[0]) == pytest.approx(1.0, abs=1e-7)
        assert float(sol.z[0]) == pytest.approx(9.0, abs=1e-5)


def test_benchmark_summary_format(tmp_path, monkeypatch):
    """benchmark.main writes a JSON summary keyed problem/inst/pt/solver."""
    monkeypatch.chdir(REPO_ROOT)
    import riptrm_tpu.experiment.benchmark as bm

    # tiny budget, one problem, one solver
    bm.main(
        [
            "--scale", "0.01", "--problems", "NonnegPCA", "--solvers", "RIPTRM",
            "solver_option.common.maxiter=3",
            f"output_path={tmp_path}/out",
            "--summary", f"{tmp_path}/summary.json",
        ]
    )
    with open(f"{tmp_path}/summary.json") as f:
        summary = json.load(f)
    assert any(k.startswith("NonnegPCA/1/a/RIPTRM") for k in summary)


def test_qp_equality_only():
    """m = 0 (no inequality rows): mu = <s,z>/m must not divide by zero and
    NaN-poison the solve (regression); result must match the closed-form
    equality-constrained KKT solution."""
    rng = np.random.default_rng(11)
    n, l = 5, 2
    Q = rng.normal(size=(n, n))
    Q = jnp.asarray(Q @ Q.T + n * np.eye(n))
    p = jnp.asarray(rng.normal(size=(n,)))
    A = jnp.asarray(rng.normal(size=(l, n)))
    b = jnp.asarray(rng.normal(size=(l,)))
    G = jnp.zeros((0, n))
    h = jnp.zeros((0,))
    sol = solve_qp(Q, p, G, h, A, b)
    x = np.asarray(sol.x)
    assert np.isfinite(x).all()
    # KKT: [Q A'; A 0] [x; y] = [-p; b]
    K = np.block([[np.asarray(Q), np.asarray(A).T], [np.asarray(A), np.zeros((l, l))]])
    ref = np.linalg.solve(K, np.concatenate([-np.asarray(p), np.asarray(b)]))
    assert np.allclose(x, ref[:n], atol=1e-7)


class TestWandbHooks:
    """wandb hooks degrade gracefully when the package is absent (this
    image has no wandb), and a fake module exercises the logging contract
    (reference streams every per-iteration row, base_solver.py:78-83)."""

    def test_absent_wandb_disables_with_warning(self):
        import warnings

        from riptrm_tpu.solvers import base

        option = {"wandb_logging": True}
        with warnings.catch_warnings(record=True):
            warnings.simplefilter("always")
            run = base.maybe_wandb_init(option, "X")
        assert run is None
        assert option["wandb_logging"] is False  # later calls short-circuit
        base.maybe_wandb_log(option, {"residual": 1.0})  # no-op, no crash
        base.maybe_wandb_finish(option)

    def test_fake_wandb_receives_rows(self, monkeypatch):
        import types

        from riptrm_tpu.solvers import base

        calls = {"init": [], "log": [], "finish": 0}
        fake = types.SimpleNamespace(
            init=lambda **kw: calls["init"].append(kw) or object(),
            log=lambda row: calls["log"].append(row),
            finish=lambda: calls.__setitem__("finish", calls["finish"] + 1),
        )
        monkeypatch.setattr(base, "_wandb", lambda: fake)
        option = {
            "wandb_logging": True,
            "wandb_project": "proj-1-a",
            "fn": lambda x: x,  # callables must be dropped from config
        }
        base.maybe_wandb_init(option, "RIPTRM_tCG")
        assert calls["init"][0]["project"] == "proj-1-a"
        assert calls["init"][0]["name"] == "RIPTRM_tCG"
        assert "fn" not in calls["init"][0]["config"]
        base.maybe_wandb_log(
            option, {"residual": 0.5, "xs": np.zeros(3), "l": [1, 2]}
        )
        # array/list values are filtered (wandb.log takes scalars here)
        assert calls["log"] == [{"residual": 0.5}]
        base.maybe_wandb_finish(option)
        assert calls["finish"] >= 1


def test_schulz_polish_reaches_lu_accuracy():
    """'schulz_polish': up to 3 exact-LU IPM polish
    iterations from the schulz endpoint must close the O(err^3) schulz
    floor toward the 'lu' solution at near-schulz cost."""
    n, m = 30, 40
    rng = np.random.default_rng(11)
    L = rng.normal(size=(n, n))
    Q = jnp.asarray(L @ L.T + 0.1 * np.eye(n))
    p = jnp.asarray(rng.normal(size=n))
    G = jnp.asarray(rng.normal(size=(m, n)))
    h = jnp.asarray(np.abs(rng.normal(size=m)) + 0.1)
    kw = dict(abstol=1e-12, reltol=1e-12, feastol=1e-12)
    s_lu = solve_qp(Q, p, G, h, method="lu", **kw)
    s_s = solve_qp(Q, p, G, h, method="schulz", **kw)
    s_p = solve_qp(Q, p, G, h, method="schulz_polish", **kw)
    ref = np.asarray(s_lu.x)
    err_s = np.linalg.norm(np.asarray(s_s.x) - ref)
    err_p = np.linalg.norm(np.asarray(s_p.x) - ref)
    # polish must not be worse than plain schulz, and must reach the lu
    # solution to deep tolerance
    assert err_p <= err_s * (1 + 1e-9)
    assert err_p < 1e-8, (err_s, err_p)
    # the polish costs at most 3 extra iterations over the schulz loop
    assert int(s_p.iterations) <= int(s_s.iterations) + 3
    # xinv warm-start carry still works through the polished variant
    s_p2 = solve_qp(Q, p, G, h, method="schulz_polish", xinv0=s_p.xinv, **kw)
    assert np.isfinite(np.asarray(s_p2.x)).all()
