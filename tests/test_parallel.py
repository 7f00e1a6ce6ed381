"""Multi-device sweep tests on the 8-device virtual CPU mesh
(a fake backend; SURVEY.md §4)."""

import pathlib

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from riptrm_tpu.parallel.sweep import (
    batched_riptrm_solve,
    init_state_from,
    make_mesh,
    run_sweep,
)
from riptrm_tpu.problems import nonneg_pca

REPO_ROOT = pathlib.Path(__file__).resolve().parents[1]

N = 16
BATCH = 8
OPTION = {
    "maxiter": 12,
    "tolresid": 1e-7,
    "TRS_solver": "tCG",
    "second_order_stationarity": False,
}


@pytest.fixture(scope="module")
def setup():
    key = jax.random.PRNGKey(0)
    k1, k2 = jax.random.split(key)
    data = nonneg_pca.generate_instance(k1, N)
    xs = np.abs(np.asarray(jax.random.normal(k2, (BATCH, N))))
    xs = xs / np.linalg.norm(xs, axis=1, keepdims=True)
    ys = np.ones((BATCH, N))
    problem = nonneg_pca.make_problem(data["Z"], xs[0])
    return problem, jnp.asarray(xs), jnp.asarray(ys)


def test_vmapped_sweep_converges(setup):
    problem, xs, ys = setup
    fn = batched_riptrm_solve(problem, OPTION, max_steps=300)
    states, ks, res = fn(xs, ys)
    assert res.shape == (BATCH,)
    assert np.all(np.asarray(res) < 1e-3)
    # each lane stayed on the sphere and feasible
    xnorms = np.linalg.norm(np.asarray(states.x), axis=1)
    np.testing.assert_allclose(xnorms, 1.0, atol=1e-10)


def test_staged_precision_sweep_deepens_floor(setup):
    """Two-phase staged-precision solve: phase 2
    continues phase-1 final states under a tighter-floor program and must
    reach a strictly deeper residual on every lane, without breaking the
    manifold invariant."""
    from riptrm_tpu.parallel.sweep import staged_precision_riptrm_solve

    problem, xs, ys = setup
    opt1 = OPTION | {
        "tolresid": 3e-4,
        "forcing_function_Lagrangian": lambda mu: jnp.maximum(mu, 1e-4),
        "forcing_function_complementarity": (
            lambda mu: jnp.maximum(1e-3 * mu, 2e-4)
        ),
    }
    opt2 = OPTION | {
        "tolresid": 1e-6,
        "forcing_function_Lagrangian": lambda mu: jnp.maximum(mu, 1e-6),
        "forcing_function_complementarity": (
            lambda mu: jnp.maximum(1e-3 * mu, 2e-6)
        ),
        "sweep_stall_window": 25,
    }
    staged = staged_precision_riptrm_solve(problem, problem, opt1, opt2, 300)
    states, ks, res2, res1 = staged(xs, ys)
    res1, res2 = np.asarray(res1), np.asarray(res2)
    assert res1.shape == res2.shape == (BATCH,)
    assert np.all(res1 < 1e-3)  # phase 1 reached its own loose target
    assert np.all(res2 < res1)  # phase 2 strictly deepened every lane
    assert np.median(res2) < np.median(res1) / 10  # and not marginally
    xnorms = np.linalg.norm(np.asarray(states.x), axis=1)
    np.testing.assert_allclose(xnorms, 1.0, atol=1e-6)


def test_sharded_sweep_matches_vmap(setup):
    problem, xs, ys = setup
    assert jax.device_count() >= 8, "conftest must provide 8 virtual devices"
    mesh = make_mesh({"dp": 8})
    xv, yv, kv, res_v = run_sweep(problem, OPTION, xs, ys, max_steps=300)
    xs_s, ys_s, ks_s, res_s = run_sweep(
        problem, OPTION, xs, ys, max_steps=300, mesh=mesh
    )
    # Different compilations reorder float reductions, so iterates diverge
    # slightly over hundreds of steps; both must converge to the same
    # solution at solver tolerance.
    np.testing.assert_allclose(np.asarray(res_s), np.asarray(res_v), rtol=5e-2)
    assert np.all(np.asarray(res_s) < 1e-3)
    np.testing.assert_allclose(np.asarray(xs_s), np.asarray(xv), atol=1e-4)


def test_graft_entry_contract():
    import sys

    sys.path.insert(0, str(REPO_ROOT))
    import __graft_entry__ as g

    fn, args = g.entry()
    out = jax.jit(fn)(*args)
    jax.block_until_ready(out)
    g.dryrun_multichip(8)


def test_sharded_materialization():
    """Sharded Hessian materialization over a tp axis matches the dense
    single-device result (SURVEY §2.3: shard the HVP fan-out)."""
    from riptrm_tpu.ops.basis import materialize_sharded, materialize_symmetrized
    from riptrm_tpu.problems import stable_identification as si

    problem = si.load_problem("dataset/StableIdentification/1", "a")
    man = problem.manifold  # dim = 40, divisible by 8
    x = problem.x0
    basis = man.basis(x)
    op = problem.lag_rhess_at(x, problem.y0)
    dense = materialize_symmetrized(man, x, basis, op)
    mesh = make_mesh({"tp": 8})
    sharded = materialize_sharded(man, x, basis, op, mesh, axis="tp")
    sharded = 0.5 * (sharded + sharded.T)
    np.testing.assert_allclose(np.asarray(sharded), np.asarray(dense), atol=1e-10)


def test_stableid_data_sharded_solve_matches():
    """StableIdentification with trajectory data sharded over a tp axis
    (BASELINE north star: 'large StableIdentification instances
    additionally shard the HVP matvec'): the compiled RIPTRM solve must
    match the unsharded solve, with X/XP partitioned across the mesh."""
    from riptrm_tpu.problems import stable_identification as si
    from riptrm_tpu.solvers.riptrm import RIPTRM

    from riptrm_tpu.ops.kkt import compute_residual
    from riptrm_tpu.solvers.riptrm import init_state
    from riptrm_tpu.utils.io import loadtxt

    mesh = make_mesh({"tp": 8})
    path = "dataset/StableIdentification/1"
    d = 5
    trajs = [loadtxt(f"{path}/noisyX_{i}.csv") for i in (1, 2, 3, 4, 5)]
    constset = loadtxt(f"{path}/constset.csv")
    x0 = tuple(loadtxt(f"{path}/init{k}_a.csv") for k in ("J", "R", "Q"))
    y0 = loadtxt(f"{path}/initineqLagmult.csv")
    plain = si.make_problem(d, trajs, constset, x0, y0)
    sharded = si.make_problem(d, trajs, constset, x0, y0, mesh=mesh)

    option = {
        "maxiter": 40,
        "tolresid": 1e-6,
        "TRS_solver": "tCG",
        "second_order_stationarity": False,
    }
    solver = RIPTRM(option)
    sp = solver.solve_compiled(plain, max_steps=200)
    ss = solver.solve_compiled(sharded, max_steps=200)
    st_p, _ = jax.jit(sp)(init_state(plain, solver.option))
    st_s, _ = jax.jit(ss)(init_state(sharded, solver.option))

    res_p = float(compute_residual(plain, st_p.x, st_p.y, jnp.zeros((0,)))[0])
    res_s = float(compute_residual(sharded, st_s.x, st_s.y, jnp.zeros((0,)))[0])
    assert res_s < 1e-5
    # Different compilations reorder float reductions and the (J, R, Q)
    # parametrization of A is redundant, so the iterates legitimately land
    # on different same-quality KKT points: compare solution QUALITY
    # (KKT residual and cost) at solver tolerance, not the iterate.
    np.testing.assert_allclose(res_s, res_p, rtol=5e-2)
    cost_p = float(plain.cost(st_p.x))
    cost_s = float(plain.cost(st_s.x))  # evaluate both on the unsharded data
    np.testing.assert_allclose(cost_s, cost_p, rtol=1e-4)


def test_certify_second_order_batch(setup):
    """Sweep with the in-loop certificate OFF, then certify all final
    points post-hoc with one batched Lanczos call (the efficient pattern
    _warn_vmapped_lanczos points at)."""
    from riptrm_tpu.parallel.sweep import certify_second_order

    problem, xs, ys = setup
    fn = batched_riptrm_solve(problem, OPTION, max_steps=200)
    states, ks, res = fn(xs, ys)
    assert float(jnp.max(res)) < 1e-3
    mineigs = certify_second_order(problem, states.x, states.y)
    mineigs = np.asarray(mineigs)
    assert mineigs.shape == (xs.shape[0],)
    # NonnegPCA maximization: converged interior-point solutions are strict
    # local minima of the barrier problem -> Hw curvature bounded below
    assert (mineigs > -1e-5).all()


def test_batched_sweep_lanczos_warning(setup):
    problem, xs, ys = setup
    import warnings

    with warnings.catch_warnings(record=True) as rec:
        warnings.simplefilter("always")
        batched_riptrm_solve(
            problem,
            OPTION | {"second_order_stationarity": True},
            max_steps=10,
        )
    assert any("Lanczos second-order check" in str(w.message) for w in rec)


def test_vmapped_exact_second_order_sweep(setup):
    """Batched EXACT-mode solves: each lane materializes Hw in its own
    tangent basis and runs the More-Sorensen TRS off one batched eigh —
    the in-loop second-order criterion (lam_min >= -tol_2nd) included."""
    problem, xs, ys = setup
    option = OPTION | {
        "TRS_solver": "Exact_RepMat",
        "second_order_stationarity": True,
        "maxiter": 200,
        "tolresid": 1e-6,
    }
    fn = batched_riptrm_solve(problem, option, max_steps=400)
    states, ks, res = jax.jit(fn)(xs, ys)
    assert np.all(np.asarray(res) < 1e-6)
    assert np.all(np.asarray(ks) < 400)  # converged, not budget-exhausted
    xnorms = np.linalg.norm(np.asarray(states.x), axis=1)
    np.testing.assert_allclose(xnorms, 1.0, atol=1e-10)


def test_checkpointed_sweep_resume(setup, tmp_path):
    """Segmented sweep with checkpointing: killing after the first segment
    and rerunning from the checkpoint reproduces the uninterrupted sweep
    (SURVEY §2.3 elasticity row: checkpoint-based restart of sweep shards)."""
    from riptrm_tpu.parallel.sweep import run_sweep_checkpointed

    problem, xs, ys = setup
    option = OPTION | {"tolresid": 1e-6, "maxiter": 30}
    ckpt = str(tmp_path / "sweep.npz")

    # uninterrupted run, no checkpointing
    x_ref, y_ref, ks_ref, res_ref = run_sweep_checkpointed(
        problem, option, xs, ys, max_steps=300, segment_steps=20
    )
    assert np.all(np.asarray(res_ref) < 1e-6)

    # "crashed" run: stop (raise) after the first segment's checkpoint
    class Kill(Exception):
        pass

    def killer(n_seg, steps, res, done):
        if n_seg == 1:
            raise Kill

    with pytest.raises(Kill):
        run_sweep_checkpointed(
            problem, option, xs, ys, max_steps=300, segment_steps=20,
            checkpoint_path=ckpt, on_segment=killer,
        )

    # resume: picks up at segment 2 and finishes
    segs = []
    x2, y2, ks2, res2 = run_sweep_checkpointed(
        problem, option, xs, ys, max_steps=300, segment_steps=20,
        checkpoint_path=ckpt,
        on_segment=lambda n, s, r, d: segs.append(n),
    )
    assert segs[0] == 2  # resumed, not restarted
    np.testing.assert_allclose(np.asarray(x2), np.asarray(x_ref), atol=1e-12)
    np.testing.assert_array_equal(np.asarray(ks2), np.asarray(ks_ref))
    np.testing.assert_allclose(np.asarray(res2), np.asarray(res_ref), rtol=1e-6)

    # resuming a FINISHED sweep is a no-op returning the same answer
    x3, y3, ks3, res3 = run_sweep_checkpointed(
        problem, option, xs, ys, max_steps=300, segment_steps=20,
        checkpoint_path=ckpt,
    )
    np.testing.assert_allclose(np.asarray(x3), np.asarray(x_ref), atol=1e-12)
    np.testing.assert_array_equal(np.asarray(ks3), np.asarray(ks_ref))


def test_checkpointed_sweep_exact_budget_and_segment_boundary(setup, tmp_path):
    """Step budgets are exact: segmentation must not overshoot max_steps,
    and any segment size must reproduce the unsegmented solve exactly —
    including lanes whose stopping criterion fires precisely on a
    segment's last step (the solve's internal done flag, not k <
    segment_steps, decides done-ness)."""
    from riptrm_tpu.parallel.sweep import run_sweep_checkpointed

    problem, xs, ys = setup
    option = OPTION | {"tolresid": 1e-6, "maxiter": 30}

    # truncated final segment: 50-step budget with 20-step segments
    _, _, ks, _ = run_sweep_checkpointed(
        problem, option, xs, ys, max_steps=50, segment_steps=20
    )
    assert np.max(np.asarray(ks)) == 50  # not rounded up to 60

    x_ref, y_ref, ks_ref, res_ref = run_sweep_checkpointed(
        problem, option, xs, ys, max_steps=300, segment_steps=300
    )
    # segment=1 makes EVERY lane's stop land exactly on a segment
    # boundary (the ambiguous k == segment_steps case); 20/23 exercise
    # mixed interior/boundary stops
    for seg in (1, 20, 23):
        x2, _, ks2, _ = run_sweep_checkpointed(
            problem, option, xs, ys, max_steps=300, segment_steps=seg
        )
        np.testing.assert_array_equal(
            np.asarray(ks2), np.asarray(ks_ref), err_msg=f"segment={seg}"
        )
        np.testing.assert_allclose(
            np.asarray(x2), np.asarray(x_ref), atol=1e-12,
            err_msg=f"segment={seg}",
        )


def test_checkpointed_sweep_sharded(setup, tmp_path):
    """Checkpointed sweep over a dp mesh: segments run sharded, and a
    resume works on a DIFFERENT device count (host-gathered checkpoints)."""
    from riptrm_tpu.parallel.sweep import make_mesh, run_sweep_checkpointed

    problem, xs, ys = setup
    option = OPTION | {"tolresid": 1e-6, "maxiter": 30}
    ckpt = str(tmp_path / "sweep_dp.npz")
    mesh8 = make_mesh({"dp": 8})

    class Kill(Exception):
        pass

    def killer(n_seg, steps, res, done):
        if n_seg == 1:
            raise Kill

    with pytest.raises(Kill):
        run_sweep_checkpointed(
            problem, option, xs, ys, max_steps=300, segment_steps=20,
            checkpoint_path=ckpt, mesh=mesh8, on_segment=killer,
        )
    mesh4 = make_mesh({"dp": 4})
    x2, y2, ks2, res2 = run_sweep_checkpointed(
        problem, option, xs, ys, max_steps=300, segment_steps=20,
        checkpoint_path=ckpt, mesh=mesh4,
    )
    assert np.all(np.asarray(res2) < 1e-6)


@pytest.mark.parametrize("solver_name", ["RIPM", "RSQO", "RALM"])
def test_batched_solver_sweep_baselines(setup, solver_name):
    """The generic batched sweep drives all four solvers.  RIPM/RSQO
    converge lane-wise; RALM's last iterate legitimately oscillates to
    ~0.7 on this random instance, but the sweep reports its BEST iterate
    (keep_best_point, solvers/ralm.py), which must match the HOST
    runner's best-within-budget residual — the reference analyzers'
    metric."""
    from riptrm_tpu.parallel.sweep import batched_solver_sweep

    problem, xs, ys = setup
    option = {"maxiter": 200, "tolresid": 1e-5}
    fn = batched_solver_sweep(problem, solver_name, option, max_steps=200)
    x_f, y_f, ks, res = fn(xs, ys)
    assert res.shape == (BATCH,)
    if solver_name == "RALM":
        from riptrm_tpu.solvers.ralm import RALM

        out = RALM({"maxiter": 200, "tolresid": 1e-5, "maxtime": 120}).run(
            problem
        )
        host_best = min(out.log["residual"])
        # Sweep lanes start from random points (xs), the host from
        # problem.x0; the dip depth is point-dependent, so compare at
        # order-of-magnitude tolerance.
        assert np.all(np.asarray(res) < 10 * host_best)
        assert np.all(np.asarray(res) < 1e-2)
    else:
        assert np.all(np.asarray(res) < 1e-5), np.asarray(res)
    xnorms = np.linalg.norm(np.asarray(x_f), axis=1)
    np.testing.assert_allclose(xnorms, 1.0, atol=1e-8)


def test_ralm_sweep_returns_best_point(setup):
    """RALM's KKT residual is non-monotone (clipped-multiplier/rho updates
    overshoot after the dip); the compiled sweep must hand back the BEST
    iterate (final-state reporting misread RALM as stalled at ~0.6).  keep_best_point=False preserves the old
    last-iterate semantics."""
    from riptrm_tpu.parallel.sweep import batched_solver_sweep

    problem, xs, ys = setup
    opt = {"maxiter": 40, "tolresid": 1e-7}
    _, _, _, res_best = batched_solver_sweep(problem, "RALM", opt, 40)(xs, ys)
    _, _, _, res_last = batched_solver_sweep(
        problem, "RALM", opt | {"keep_best_point": False}, 40
    )(xs, ys)
    res_best, res_last = np.asarray(res_best), np.asarray(res_last)
    assert np.all(res_best < 1e-2)  # the dip is reachable and reported
    assert np.all(res_best <= res_last + 1e-12)


def test_batched_protocol_sweep_time_to_target(setup):
    """Per-lane time-to-target: best-so-far <= final residual always; a
    loose target stops a lane in strictly fewer steps than target=0
    (which runs the full maxiter/tolresid schedule)."""
    from riptrm_tpu.parallel.sweep import batched_protocol_sweep

    problem, xs, ys = setup
    option = {
        "maxiter": 60,
        "tolresid": 1e-9,
        "TRS_solver": "tCG",
        "second_order_stationarity": False,
    }
    fn = batched_protocol_sweep(problem, "RIPTRM", option, max_steps=400)
    zeros = jnp.zeros((BATCH,))
    x0_, y0_, ks_full, best_full = fn(xs, ys, zeros)
    from riptrm_tpu.ops.kkt import compute_residual

    res_final = jax.vmap(
        lambda x, y: compute_residual(problem, x, y, jnp.zeros((0,)))[0]
    )(x0_, y0_)
    assert np.all(np.asarray(best_full) <= np.asarray(res_final) + 1e-12)
    assert np.all(np.asarray(best_full) < 1e-6)

    loose = jnp.full((BATCH,), 1e-2)
    _, _, ks_loose, best_loose = fn(xs, ys, loose)
    assert np.all(np.asarray(ks_loose) < np.asarray(ks_full))
    assert np.all(np.asarray(best_loose) <= 1e-2)


def test_batched_exact_defaults_to_ms():
    """Batched builders default exact_trs_method to 'ms' (the vmapped eigh
    cache is select-dead) unless the caller sets
    it; non-exact options pass through untouched."""
    from riptrm_tpu.parallel.sweep import _batched_exact_defaults

    o = _batched_exact_defaults({"TRS_solver": "Exact_RepMat"})
    assert o["exact_trs_method"] == "ms"
    o2 = _batched_exact_defaults(
        {"TRS_solver": "Exact_RepMat", "exact_trs_method": "eigh"}
    )
    assert o2["exact_trs_method"] == "eigh"  # explicit choice wins
    o3 = {"TRS_solver": "tCG"}
    assert _batched_exact_defaults(o3) is o3  # untouched


def test_sweep_stall_window_freezes_stalled_lane(setup):
    """With sweep_stall_window set, a lane that cannot improve its best
    residual stops early instead of burning max_steps; without it, the
    unreachable-target lane runs the full budget (lockstep guard,
    solvers/base.py::compiled_best_while)."""
    from riptrm_tpu.parallel.sweep import batched_protocol_sweep

    problem, xs, ys = setup
    base = dict(OPTION, maxiter=200, tolresid=1e-30)
    targets = jnp.full((BATCH,), 1e-30)  # unreachable: forces stall behavior
    fn_full = batched_protocol_sweep(problem, "RSQO", base, max_steps=200)
    _, _, ks_full, best_full = fn_full(xs, ys, targets)
    fn_stall = batched_protocol_sweep(
        problem, "RSQO", dict(base, sweep_stall_window=10), max_steps=200
    )
    _, _, ks_stall, best_stall = fn_stall(xs, ys, targets)
    assert np.all(np.asarray(ks_stall) < np.asarray(ks_full))
    # frozen lanes still report their honest best-so-far (same magnitude)
    assert np.all(np.asarray(best_stall) < 1e-2)


def test_speedrun_rescue_pass(setup):
    """The protocol-speedrun rescue branch (experiment/protocol_speedrun.py
    ::rescue_missed_lanes): lanes whose batched best misses the target are
    re-run unbatched; lanes at target are left alone.  Forced miss: one
    lane's target is set below anything reachable, one in easy reach."""
    from riptrm_tpu.experiment.protocol_speedrun import rescue_missed_lanes
    from riptrm_tpu.parallel.sweep import batched_protocol_sweep

    problem, xs, ys = setup
    option = dict(OPTION, maxiter=40)
    fn = batched_protocol_sweep(problem, "RIPTRM", option, max_steps=60)
    # lane 0: unreachable target (forces the rescue re-run); rest: loose
    targets = [0.0] + [1e-1] * (BATCH - 1)
    targets[0] = 1e-30
    x_f, y_f, ks, best = fn(xs, ys, jnp.asarray(targets))
    best_h = np.array(best)
    ks_h = np.array(ks)
    pre_best = best_h.copy()
    assert not (best_h[0] <= targets[0])  # the miss the rescue must see
    assert np.all(best_h[1:] <= 1e-1)

    rescued, run_s, compile_s = rescue_missed_lanes(
        problem, "RIPTRM", option, 60, xs, ys, targets, best_h, ks_h
    )
    assert rescued == [True] + [False] * (BATCH - 1)
    assert run_s >= 0.0 and compile_s > 0.0
    # rescue keeps each lane's better result, never regresses
    assert best_h[0] <= pre_best[0]
    np.testing.assert_array_equal(best_h[1:], pre_best[1:])

    # no misses -> no-op, no compile paid
    rescued2, run2, comp2 = rescue_missed_lanes(
        problem, "RIPTRM", option, 60, xs, ys,
        [1e-1] * BATCH, np.array(pre_best), np.array(ks),
    )
    assert rescued2 == [False] * BATCH and run2 == 0.0 and comp2 == 0.0


@pytest.mark.parametrize("solver_name", ["RIPM", "RSQO", "RALM"])
def test_batched_protocol_sweep_baselines(setup, solver_name):
    from riptrm_tpu.parallel.sweep import batched_protocol_sweep

    problem, xs, ys = setup
    option = {"maxiter": 150, "tolresid": 1e-9}
    fn = batched_protocol_sweep(problem, solver_name, option, max_steps=150)
    target = {"RIPM": 1e-5, "RSQO": 1e-5, "RALM": 1e-1}[solver_name]
    targets = jnp.full((BATCH,), target)
    _, _, ks, best = fn(xs, ys, targets)
    assert np.all(np.asarray(best) <= target)
    assert np.all(np.asarray(ks) < 150)  # stopped at target, not budget


def test_checkpointed_sweep_pytree_points(tmp_path):
    """Product-manifold starts are pytrees ((J, R, Q) tuples): the
    checkpointed sweep must map over leaves, not collapse them into one
    stacked array (regression: jnp.asarray on the tuple)."""
    from riptrm_tpu.experiment.chip_sweep import build_sweep
    from riptrm_tpu.parallel.sweep import run_sweep_checkpointed

    problem, xs0, ys0 = build_sweep("StableIdentification", 3, 2, seed=1)
    option = {
        "maxiter": 10,
        "tolresid": 1e-4,
        "TRS_solver": "tCG",
        "second_order_stationarity": False,
    }
    x, y, ks, res = run_sweep_checkpointed(
        problem, option, xs0, ys0, max_steps=60, segment_steps=25,
        checkpoint_path=str(tmp_path / "si.npz"),
    )
    assert np.all(np.isfinite(np.asarray(res)))
    assert all(leaf.shape[0] == 2 for leaf in jax.tree.leaves(x))


def test_certify_second_order_ratio_cap(setup):
    """At a deeply-converged KKT point active constraints make y/c huge
    and the uncapped Lanczos returns rounding garbage; the capped
    certificate (PSD barrier term clamped -> conservative) stays at the
    Lagrangian-curvature scale."""
    from riptrm_tpu.parallel.sweep import certify_second_order

    problem, xs, ys = setup
    option = OPTION | {"maxiter": 40, "tolresid": 1e-12}
    fn = batched_riptrm_solve(problem, option, max_steps=400)
    states, ks, res = fn(xs, ys)
    assert np.all(np.asarray(res) < 1e-10)  # deep convergence (x64 CPU)
    capped = np.asarray(
        certify_second_order(problem, states.x, states.y, ratio_cap=1e8)
    )
    # curvature at the Lagrangian scale (|Z| ~ O(1)), and nonnegative
    # at a strict minimizer
    assert np.all(capped > -1e-6) and np.all(np.abs(capped) < 1e3)


def test_protocol_best_counts_initial_residual(setup):
    """The protocol metric includes the iteration-0 row: a lane whose
    target equals its STARTING residual must stop immediately instead of
    burning the budget (best is seeded with the initial residual)."""
    from riptrm_tpu.ops.kkt import compute_residual
    from riptrm_tpu.parallel.sweep import batched_protocol_sweep

    problem, xs, ys = setup
    res0 = jax.vmap(
        lambda x, y: compute_residual(problem, x, y, jnp.zeros((0,)))[0]
    )(xs, ys)
    fn = batched_protocol_sweep(
        problem,
        "RIPTRM",
        {"maxiter": 60, "tolresid": 1e-9, "TRS_solver": "tCG",
         "second_order_stationarity": False},
        max_steps=400,
    )
    _, _, ks, best = fn(xs, ys, res0)  # target = starting residual
    assert np.all(np.asarray(ks) == 0)
    np.testing.assert_allclose(np.asarray(best), np.asarray(res0), rtol=1e-12)


def test_checkpoint_identity_mismatch_refuses_resume(setup, tmp_path):
    """Reusing a checkpoint_path for a DIFFERENT sweep (same state shapes,
    different initial points) must fail loudly instead of silently
    discarding the caller's xs0/ys0 and resuming the wrong state."""
    from riptrm_tpu.parallel.sweep import run_sweep_checkpointed

    problem, xs, ys = setup
    option = OPTION | {"tolresid": 1e-6, "maxiter": 30}
    ckpt = str(tmp_path / "sweep.npz")
    run_sweep_checkpointed(
        problem, option, xs, ys, max_steps=40, segment_steps=20,
        checkpoint_path=ckpt,
    )
    other_xs = jnp.roll(xs, 1, axis=0)  # same shapes, different sweep
    with pytest.raises(ValueError, match="sweep_id"):
        run_sweep_checkpointed(
            problem, option, other_xs, ys, max_steps=40, segment_steps=20,
            checkpoint_path=ckpt,
        )
    # a different option dict is also a different sweep
    with pytest.raises(ValueError, match="sweep_id"):
        run_sweep_checkpointed(
            problem, option | {"tolresid": 1e-8}, xs, ys,
            max_steps=40, segment_steps=20, checkpoint_path=ckpt,
        )
    # the SAME sweep still resumes fine
    run_sweep_checkpointed(
        problem, option, xs, ys, max_steps=40, segment_steps=20,
        checkpoint_path=ckpt,
    )


def test_certify_ratio_cap_flags_infeasible_lanes(setup):
    """Capped certificates are conservative ONLY at feasible points; a lane
    with min(slack) <= 0 must come back NaN, not a certified number."""
    from riptrm_tpu.parallel.sweep import certify_second_order

    problem, xs, ys = setup
    bad = np.asarray(xs).copy()
    bad[0, 0] = -abs(bad[0, 0]) - 0.1  # negative entry => slack < 0
    bad = bad / np.linalg.norm(bad, axis=1, keepdims=True)
    out = np.asarray(
        certify_second_order(problem, jnp.asarray(bad), ys, ratio_cap=1e8)
    )
    assert np.isnan(out[0])
    assert np.all(np.isfinite(out[1:]))


def test_staged_precision_compacted_matches_floor():
    """Lane compaction: the host-segmented staged
    solve must reach the same residual class as a plain staged phase-2
    while letting converged/floored lanes exit the active set early."""
    import numpy as np
    from riptrm_tpu.experiment.chip_sweep import build_sweep
    from riptrm_tpu.parallel.sweep import staged_precision_riptrm_compacted
    from riptrm_tpu.problems import nonneg_pca

    problem, xs0, ys0 = build_sweep("NonnegPCA", 32, 4, seed=0)
    problem_hi = nonneg_pca.make_problem(
        problem.structure["Zs"], np.asarray(xs0[0]),
        dtype=jnp.float32, matmul_precision="highest",
    )
    option = {
        "maxiter": 60, "tolresid": 1e-3, "TRS_solver": "tCG",
        "second_order_stationarity": False,
        "forcing_function_Lagrangian": lambda mu: jnp.maximum(mu, 1e-4),
        "forcing_function_complementarity": (
            lambda mu: jnp.maximum(1e-3 * mu, 2e-4)
        ),
    }
    option_hi = option | {
        "tolresid": 1e-5,
        "forcing_function_Lagrangian": lambda mu: jnp.maximum(mu, 1e-5),
        "forcing_function_complementarity": (
            lambda mu: jnp.maximum(1e-3 * mu, 2e-5)
        ),
    }
    run = staged_precision_riptrm_compacted(
        problem, problem_hi, option, option_hi, max_steps=300,
        segment_steps=60,
    )
    best, res1, segs = run(xs0, ys0)
    assert best.shape == (4,) and segs.shape == (4,)
    # phase 2 must not regress phase 1 and must reach the tighter class
    assert np.all(best <= res1 * (1 + 1e-5))
    assert np.median(best) < 1e-4
    # every lane exited (converged or floored) within the budget
    assert np.all(segs >= 1)
