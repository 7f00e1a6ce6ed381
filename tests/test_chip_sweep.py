"""chip_sweep CLI: instance generation + batched sweep measurement (CPU)."""

import jax.numpy as jnp
import numpy as np

from riptrm_tpu.experiment.chip_sweep import build_sweep, measure_sweep


def test_build_sweep_stable_identification():
    problem, xs0, ys0 = build_sweep("StableIdentification", 3, 2, seed=1)
    # stacked product-manifold points: (J, R, Q) leaves with batch axis
    assert all(leaf.shape == (2, 3, 3) for leaf in xs0)
    assert ys0.shape == (2, problem.num_ineq)
    # every generated start must be strictly feasible interior
    for b in range(2):
        x = tuple(leaf[b] for leaf in xs0)
        assert np.all(np.asarray(problem.ineq_val(x)) < 0)
        assert np.isfinite(float(problem.manvio(x)))


def test_build_sweep_rosenbrock():
    problem, xs0, ys0 = build_sweep("Rosenbrock", 5, 3, seed=2)
    assert xs0.shape == (3, 5, 3)  # Grassmann(5, 3) matrix points
    assert ys0.shape == (3, problem.num_ineq)
    for b in range(3):
        x = np.asarray(xs0[b])
        # on-manifold (orthonormal columns) and feasible starts
        np.testing.assert_allclose(x.T @ x, np.eye(3), atol=1e-5)
        assert np.all(np.asarray(problem.ineq_val(xs0[b])) < 0)


def test_measure_sweep_nonneg_pca():
    problem, xs0, ys0 = build_sweep("NonnegPCA", 32, 2, seed=0)
    assert xs0.shape == (2, 32)
    option = {
        "maxiter": 60,
        "tolresid": 1e-3,
        "TRS_solver": "tCG",
        "second_order_stationarity": False,
        "forcing_function_Lagrangian": lambda mu: jnp.maximum(mu, 1e-4),
        "forcing_function_complementarity": lambda mu: jnp.maximum(1e-3 * mu, 2e-4),
    }
    per_sweep, res, _, k_max = measure_sweep(
        problem, xs0, ys0, option, max_steps=150, reps=2
    )
    assert per_sweep > 0
    assert res.shape == (2,)
    assert np.all(res < 1e-2)


def test_measure_sweep_rsqo_schulz():
    """The --rsqo-linear-solver=schulz sweep path (factorization-free QP,
    pure batched matmuls) must converge the batched RSQO sweep to the
    same residual class as the Cholesky path."""
    problem, xs0, ys0 = build_sweep("NonnegPCA", 32, 2, seed=0)
    option = {
        "maxiter": 40,
        "tolresid": 1e-3,
        "quadoptim_type": "reghess_shift",
        "quadoptim_linear_solver": "schulz",
    }
    per_sweep, res, _, _ = measure_sweep(
        problem, xs0, ys0, option, max_steps=60, reps=2, solver="RSQO",
    )
    assert per_sweep > 0
    assert np.all(res < 1e-2)


def test_build_sweep_bounded_pca():
    problem, xs0, ys0 = build_sweep("BoundedPCA", 32, 2, seed=3)
    assert xs0.shape[0] == 2 and xs0.shape[1] == 32
    for b in range(2):
        x = np.asarray(xs0[b])
        np.testing.assert_allclose(x.T @ x, np.eye(x.shape[1]), atol=1e-5)
        assert np.all(np.asarray(problem.ineq_val(xs0[b])) < 0)


def test_build_sweep_low_rank():
    problem, xs0, ys0 = build_sweep("LowRank", 16, 2, seed=4)
    u, s, v = (np.asarray(l) for l in (xs0[0], xs0[1], xs0[2]))
    assert u.shape[0] == 2  # batch axis on every factor leaf
    for b in range(2):
        x = tuple(leaf[b] for leaf in xs0)
        assert np.all(np.asarray(problem.slack(x)) > 0)


def test_build_sweep_cache_roundtrip(tmp_path, monkeypatch):
    """The generated-instance cache: a second
    build_sweep must hit the npz and reproduce the identical sweep, and a
    smaller-batch request must slice a larger-batch cache entry."""
    monkeypatch.setenv("RIPTRM_CACHE_DIR", str(tmp_path))
    from riptrm_tpu.experiment.chip_sweep import _cache_load

    p1, xs1, ys1 = build_sweep("StableIdentification", 3, 3, seed=7)
    files = list(tmp_path.glob("StableIdentification_s3_seed7_b3.npz"))
    assert len(files) == 1
    assert _cache_load("StableIdentification", 3, 3, 7) is not None

    p2, xs2, ys2 = build_sweep("StableIdentification", 3, 3, seed=7)
    for a, b in zip(jnp_tree_leaves(xs1), jnp_tree_leaves(xs2)):
        np.testing.assert_array_equal(np.asarray(a), np.asarray(b))
    np.testing.assert_array_equal(
        np.asarray(p1.ineq_val(tuple(l[0] for l in xs1))),
        np.asarray(p2.ineq_val(tuple(l[0] for l in xs2))),
    )

    # batch=2 served by slicing the b=3 entry (no regeneration: the lanes
    # must be the FIRST TWO of the cached batch, not fresh draws)
    _, xs3, _ = build_sweep("StableIdentification", 3, 2, seed=7)
    for a, b in zip(jnp_tree_leaves(xs1), jnp_tree_leaves(xs3)):
        np.testing.assert_array_equal(np.asarray(a)[:2], np.asarray(b))

    # cache=False bypasses both read and write
    build_sweep("NonnegPCA", 8, 2, seed=7, cache=False)
    assert _cache_load("NonnegPCA", 8, 2, 7) is None


def jnp_tree_leaves(tree):
    import jax

    return jax.tree.leaves(tree)


def test_f32_sweep_option_converges_bounded_pca_lanes():
    """St(128, 8), 16 starts in float32: with the reference's 1e3-ulp
    ared/pred regularization about half of these lanes churn at mu = 0.1
    (residual 4.525); ``f32_sweep_option`` converges all of them."""
    import jax

    from riptrm_tpu.experiment.chip_sweep import f32_sweep_option
    from riptrm_tpu.parallel.sweep import batched_riptrm_solve

    with jax.enable_x64(False), jax.default_matmul_precision("highest"):
        problem, xs0, ys0 = build_sweep(
            "BoundedPCA", 128, 16, seed=0, matmul_precision="highest"
        )
        option = f32_sweep_option(problem)
        _, ks, res = batched_riptrm_solve(problem, option, 400)(xs0, ys0)
    assert np.all(np.asarray(res) <= 3e-4)
    assert int(np.max(np.asarray(ks))) < 400


def test_cpu_x64_residuals_matches_device_residuals():
    """The host float64 re-evaluation agrees with the solver's own f32
    residuals at its final points."""
    import jax

    from riptrm_tpu.experiment.chip_sweep import cpu_x64_residuals, f32_sweep_option
    from riptrm_tpu.parallel.sweep import batched_riptrm_solve

    with jax.enable_x64(False), jax.default_matmul_precision("highest"):
        problem, xs0, ys0 = build_sweep(
            "NonnegPCA", 32, 4, seed=0, matmul_precision="highest"
        )
        states, _, res = batched_riptrm_solve(
            problem, f32_sweep_option(problem), 400
        )(xs0, ys0)
    res64 = cpu_x64_residuals("NonnegPCA", 32, 4, 0, states.x, states.y)
    assert res64.dtype == np.float64 and res64.shape == (4,)
    np.testing.assert_allclose(res64, np.asarray(res), rtol=0.1)
