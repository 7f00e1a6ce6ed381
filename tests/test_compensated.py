"""Accuracy tests for ops/compensated.py against f64 ground truth.

These run in f32 deliberately (conftest enables x64, so f32 arrays must be
constructed explicitly): the whole point of the module is the f32 batched
-lane floor.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from riptrm_tpu.ops import compensated as comp


def _f32(x):
    return jnp.asarray(np.asarray(x, np.float32), jnp.float32)


class TestErrorFreeTransforms:
    def test_two_sum_exact(self):
        rng = np.random.default_rng(0)
        a = _f32(rng.normal(size=256) * 10.0 ** rng.integers(-6, 6, 256))
        b = _f32(rng.normal(size=256) * 10.0 ** rng.integers(-6, 6, 256))
        s, e = comp.two_sum(a, b)
        exact = np.asarray(a, np.float64) + np.asarray(b, np.float64)
        np.testing.assert_array_equal(
            np.asarray(s, np.float64) + np.asarray(e, np.float64), exact
        )

    def test_two_prod_exact(self):
        rng = np.random.default_rng(1)
        a = _f32(rng.normal(size=256))
        b = _f32(rng.normal(size=256))
        p, e = comp.two_prod(a, b)
        exact = np.asarray(a, np.float64) * np.asarray(b, np.float64)
        np.testing.assert_array_equal(
            np.asarray(p, np.float64) + np.asarray(e, np.float64), exact
        )

    def test_two_prod_f64_splitter(self):
        rng = np.random.default_rng(2)
        a = jnp.asarray(rng.normal(size=64))
        b = jnp.asarray(rng.normal(size=64))
        assert a.dtype == jnp.float64
        p, e = comp.two_prod(a, b)
        # p + e reproduces the f64 product to quad-accuracy: check via the
        # residual of p against the exact product minus e
        err = np.asarray(p) - (np.asarray(a) * np.asarray(b) - np.asarray(e))
        assert np.max(np.abs(err)) == 0.0


class TestSum2:
    def test_illconditioned_sum(self):
        # huge cancellation: +/- pairs plus a tiny tail; naive f32 loses it
        rng = np.random.default_rng(3)
        big = rng.normal(size=2048).astype(np.float32) * 1e6
        tail = rng.normal(size=2048).astype(np.float32) * 1e-4
        x = np.concatenate([big, -big, tail]).astype(np.float32)
        rng.shuffle(x)
        exact = float(np.sum(np.asarray(x, np.float64)))
        got = float(comp.sum2(_f32(x)))
        naive = float(jnp.sum(_f32(x)))
        # measured: got err ~3e-7 (eps-level of the surviving tail), naive
        # err ~10 — the cancelled 1e6-scale bulk destroys the naive sum
        assert abs(got - exact) <= 1e-3 * abs(exact)
        assert abs(naive - exact) > 1e3 * abs(got - exact)

    def test_odd_length_and_axis(self):
        rng = np.random.default_rng(4)
        x = _f32(rng.normal(size=(5, 777)))
        got = np.asarray(comp.sum2(x, axis=-1))
        exact = np.sum(np.asarray(x, np.float64), axis=-1)
        np.testing.assert_allclose(got, exact, rtol=1e-6)
        got0 = np.asarray(comp.sum2(x, axis=0))
        exact0 = np.sum(np.asarray(x, np.float64), axis=0)
        np.testing.assert_allclose(got0, exact0, rtol=1e-6)

    def test_vmap_batch(self):
        rng = np.random.default_rng(5)
        x = _f32(rng.normal(size=(8, 1000)))
        got = np.asarray(jax.vmap(comp.sum2)(x))
        exact = np.sum(np.asarray(x, np.float64), axis=-1)
        np.testing.assert_allclose(got, exact, rtol=1e-6)


class TestComplementarityNorm:
    def test_recovers_subfloor_residual(self):
        """y*c == mu*(1 + delta) with delta ~ 1e-3 relative: the naive f32
        norm is polluted at eps*mu*sqrt(m); the compensated one matches
        f64 to f32 roundoff of the RESIDUAL."""
        rng = np.random.default_rng(6)
        m = 4096
        mu = np.float32(1e-2)
        c = rng.uniform(0.5, 2.0, m).astype(np.float32)
        delta = (rng.normal(size=m) * 1e-3).astype(np.float32)
        y = (np.float64(mu) * (1.0 + np.asarray(delta, np.float64))
             / np.asarray(c, np.float64)).astype(np.float32)
        exact = float(np.linalg.norm(
            np.asarray(y, np.float64) * np.asarray(c, np.float64)
            - np.float64(mu)
        ))
        got = float(comp.complementarity_norm(_f32(y), _f32(c), mu))
        naive = float(jnp.linalg.norm(_f32(y) * _f32(c) - mu))
        assert abs(got - exact) <= 1e-5 * exact
        assert abs(naive - exact) >= abs(got - exact)

    def test_deep_residual_floor(self):
        """delta = 0 exactly (y = fl(mu/c)): the true residual of the f32
        inputs is their representation error, ~eps*mu*sqrt(m).  The
        compensated norm must reproduce the f64-exact norm of those f32
        inputs to f32 roundoff — i.e. it adds NO noise of its own.  (The
        naive norm is only ~1% off here: for f32 inputs the input
        representation error is the same order as the product-rounding
        noise, which bounds what any reduction fix can buy.)"""
        rng = np.random.default_rng(7)
        m = 4096
        mu = np.float32(3e-3)
        c = rng.uniform(0.5, 2.0, m).astype(np.float32)
        y = (np.float32(mu) / c).astype(np.float32)
        exact = float(np.linalg.norm(
            np.asarray(y, np.float64) * np.asarray(c, np.float64)
            - np.float64(mu)
        ))
        got = float(comp.complementarity_norm(_f32(y), _f32(c), mu))
        naive = float(jnp.linalg.norm(_f32(y) * _f32(c) - mu))
        assert abs(got - exact) <= 1e-6 * exact
        # compensated is never worse than naive
        assert abs(got - exact) <= abs(naive - exact) + 1e-12 * exact


class TestBarrierLogRatioSum:
    def test_tiny_relative_moves(self):
        rng = np.random.default_rng(8)
        m = 4096
        mu = np.float32(1e-3)
        c = rng.uniform(0.5, 2.0, m).astype(np.float32)
        c_new = c * (1.0 + rng.normal(size=m).astype(np.float32) * 1e-5)
        exact = float(np.float64(mu) * np.sum(np.log(
            np.asarray(c_new, np.float64) / np.asarray(c, np.float64)
        )))
        got = float(comp.barrier_log_ratio_sum(_f32(c_new), _f32(c), mu))
        naive = float(mu * jnp.sum(jnp.log(_f32(c_new) / _f32(c))))
        assert abs(got - exact) <= 1e-4 * abs(exact) + 1e-10
        assert abs(naive - exact) >= abs(got - exact)

    def test_matches_naive_masking(self):
        # nonpositive slacks contribute 0, like the naive ratio=1 masking
        c = _f32([1.0, -0.5, 2.0, 0.0])
        c_new = _f32([2.0, 1.0, -1.0, 3.0])
        got = float(comp.barrier_log_ratio_sum(c_new, c, np.float32(1.0)))
        assert got == pytest.approx(np.log(2.0), rel=1e-6)

    def test_large_ratio_branch(self):
        c = _f32([1.0, 1.0])
        c_new = _f32([0.25, 8.0])  # ratios outside [1/2, 2]
        got = float(comp.barrier_log_ratio_sum(c_new, c, np.float32(1.0)))
        assert got == pytest.approx(np.log(0.25) + np.log(8.0), rel=1e-6)


class TestSolverIntegration:
    def test_riptrm_equivalent_at_tolerance(self):
        """compensated_reductions on/off reach the same solution at solver
        tolerance on the golden NonnegPCA instance (f32: trajectories may
        differ step-for-step — CLAUDE-documented chaos at accept/reject
        thresholds — but the converged optimum must agree)."""
        from riptrm_tpu.problems import nonneg_pca
        from riptrm_tpu.solvers.riptrm import RIPTRM

        p = nonneg_pca.load_problem("dataset/NonnegPCA/1", "a", dtype=jnp.float32)
        opt = {
            "maxtime": 120, "maxiter": 30, "TRS_solver": "tCG",
            "second_order_stationarity": False, "tolresid": 1e-4,
            "forcing_function_Lagrangian": lambda mu: jnp.maximum(mu, 1e-5),
            "forcing_function_complementarity": (
                lambda mu: jnp.maximum(1e-3 * mu, 1e-5)
            ),
        }
        base = RIPTRM(opt).run(p)
        compd = RIPTRM(opt | {"compensated_reductions": True}).run(p)
        assert base.log["residual"][-1] <= 1e-4
        assert compd.log["residual"][-1] <= 1e-4
        np.testing.assert_allclose(
            np.asarray(compd.x), np.asarray(base.x), atol=5e-3
        )
