"""GPU bring-up: the YAML-subset loader, the compile-cache helper, the
smoke run's phases at tiny sizes on the CPU, and the XLA tCG against a
dense-eigh TRS reference for the sphere-quadratic and Stiefel-bound
problem structures."""

import pathlib

import jax
import jax.numpy as jnp
import numpy as np
import pytest

REPO_ROOT = pathlib.Path(__file__).resolve().parents[1]
CONFIGS = sorted(p.relative_to(REPO_ROOT).as_posix()
                 for p in REPO_ROOT.glob("configs/*/*.yaml"))


# ------------------------------------------------------------- YAML subset
@pytest.mark.parametrize("path", CONFIGS)
def test_yaml_loader_matches_pyyaml(path):
    yaml = pytest.importorskip("yaml")
    from riptrm_tpu.experiment.cfg import yaml_load

    text = (REPO_ROOT / path).read_text()
    assert yaml_load(text) == yaml.safe_load(text)


def test_config_count():
    assert len(CONFIGS) == 10


@pytest.mark.parametrize("value,expected", [
    ("true", True), ("Off", False), ("240", 240), ("1e-2", 0.01),
    ("0.5", 0.5), ("[RIPTRM, 'RSQO']", ["RIPTRM", "RSQO"]), ("a,b", "a,b"),
    ("null", None), ("'x # y'", "x # y"), ("3 # comment", 3),
])
def test_override_scalars(value, expected):
    """CLI override values parse as YAML 1.1 scalars (then coerced)."""
    from riptrm_tpu.experiment.cfg import _parse_scalar

    assert _parse_scalar(value) == expected


def test_yaml_loader_rejects_unsupported():
    from riptrm_tpu.experiment.cfg import yaml_load

    for text in ("a:\n  - 1\n", "a: {b: 1}\n", "a: 1\n  b: 2\n"):
        with pytest.raises(ValueError):
            yaml_load(text)


# ---------------------------------------------------------- compile cache
def _record_updates(monkeypatch):
    from riptrm_tpu import config

    calls = []
    monkeypatch.setattr(jax.config, "update", lambda k, v: calls.append((k, v)))
    return config, calls


def test_compile_cache_env_set(monkeypatch, tmp_path):
    config, calls = _record_updates(monkeypatch)
    monkeypatch.setenv("JAX_COMPILATION_CACHE_DIR", str(tmp_path))
    assert config.enable_compile_cache() is None


def test_compile_cache_env_set_writes_no_config(monkeypatch, tmp_path):
    config, calls = _record_updates(monkeypatch)
    monkeypatch.setenv("JAX_COMPILATION_CACHE_DIR", str(tmp_path))
    config.setup(cpu=False, x64=False)
    assert not [k for k, _ in calls if "cache" in k]


def test_compile_cache_env_unset(monkeypatch):
    config, calls = _record_updates(monkeypatch)
    monkeypatch.delenv("JAX_COMPILATION_CACHE_DIR", raising=False)
    path = config.enable_compile_cache()
    assert path == str(REPO_ROOT / ".jax_cache")
    assert pathlib.Path(path).is_dir()
    assert ("jax_compilation_cache_dir", path) in calls


# ------------------------------------------------------------- smoke run
@pytest.fixture
def chip_smoke(monkeypatch):
    monkeypatch.chdir(REPO_ROOT)
    monkeypatch.syspath_prepend(str(REPO_ROOT))
    import chip_smoke

    return chip_smoke


SMALL_PHASES = {
    "protocol": ("phase_protocol", dict(problems=("Rosenbrock",),
                                        solvers=("RIPTRM", "RSQO"))),
    "sweep": ("phase_sweep", dict(problem_name="NonnegPCA", size=16, batch=4,
                                  reps=1)),
    "exact": ("phase_exact", dict(sizes=(16,))),
    "baselines": ("phase_baselines", dict(size=16, batch=4)),
    "other": ("phase_other", dict(cases=(
        ("BoundedPCA", 32, 4, 400, 3e-4, False),
        ("Rosenbrock", 8, 4, 400, 10.0, True),  # CPU float64 median 6.4
        ("StableIdentification", 3, 2, 400, 3e-4, False),
    ))),
}


@pytest.mark.parametrize("phase", sorted(SMALL_PHASES))
def test_chip_smoke_phase_small(chip_smoke, phase):
    name, kwargs = SMALL_PHASES[phase]
    rec = getattr(chip_smoke, name)(**kwargs)
    assert rec  # the phase raises PhaseFailed when its check misses


def test_chip_smoke_multi_device_small(chip_smoke):
    """The --four-gpus phase on 4 virtual CPU devices at tiny sizes."""
    rec = chip_smoke.phase_multi_device(jax.devices()[:4], size=16, batch=8,
                                        sid_d=3)
    assert {"dp", "dp_tp", "sid_step"} <= set(rec)


def test_chip_smoke_main_refuses_cpu(chip_smoke, capsys):
    with pytest.raises(SystemExit) as exc:
        chip_smoke.main([])
    assert exc.value.code != 0
    assert '"ok": true' not in capsys.readouterr().out


@pytest.mark.gpu
def test_chip_smoke_phase_small_on_gpu(chip_smoke, gpu_device):
    """The float32 sweep phase as compiled for the card (README: tests)."""
    assert chip_smoke.phase_sweep("NonnegPCA", 16, 4, reps=1)


def test_device_busy_interval_union():
    from riptrm_tpu.experiment.gpu_measure import interval_union_ns

    assert interval_union_ns([]) == 0
    assert interval_union_ns([(0, 10), (5, 12), (20, 25), (21, 22)]) == 17


# ------------------------------------------------- XLA tCG vs dense TRS
def _nonneg_pca(seed):
    from riptrm_tpu.problems import nonneg_pca

    n = 12
    k1, k2 = jax.random.split(jax.random.PRNGKey(seed))
    z = nonneg_pca.generate_instance(k1, n)["Z"]
    x0 = nonneg_pca.generate_initialpoint(k2, n)
    return nonneg_pca.make_problem(z, x0)


def _bounded_pca(seed):
    from riptrm_tpu.problems import bounded_pca

    n, p = 10, 2
    k1, k2 = jax.random.split(jax.random.PRNGKey(seed))
    z = bounded_pca.generate_instance(k1, n)["Z"]
    x0 = bounded_pca.generate_initialpoint(k2, n, p)
    return bounded_pca.make_problem(z, x0)


STRUCTURES = {"sphere_quadratic": _nonneg_pca, "stiefel_bound": _bounded_pca}


def _tcg_and_trs(problem, x, y, radius_scale):
    """XLA tCG (tight kappa) and the dense-eigh TRS at one point; returns
    (tCG model value, TRS model value, Cauchy model value, ||tCG step||,
    ||TRS step||, radius)."""
    from riptrm_tpu.ops.basis import materialize_symmetrized
    from riptrm_tpu.ops.tcg import truncated_cg
    from riptrm_tpu.ops.trs import solve_trs_eig
    from riptrm_tpu.solvers.riptrm import _barrier_ops

    man = problem.manifold
    mu = jnp.asarray(0.1, y.dtype)
    _, hw, cx = _barrier_ops(problem, x, y, mu)
    basis = man.basis(x)
    h = materialize_symmetrized(man, x, basis, hw)
    g = man.to_coords(x, basis, cx)
    lam, q = jnp.linalg.eigh(h)
    newton = jnp.linalg.norm(jnp.linalg.solve(h, g))
    radius = radius_scale * newton
    coeff, _, _, _ = solve_trs_eig(lam, q, g, radius)
    dx, h_dx, _, _ = truncated_cg(man, x, hw, cx, radius, theta=1.0,
                                  kappa=1e-12, maxinner=man.dim)
    m_tcg = man.inner(x, cx, dx) + 0.5 * man.inner(x, dx, h_dx)
    m_trs = g @ coeff + 0.5 * coeff @ (h @ coeff)
    t = radius / jnp.linalg.norm(g)  # Cauchy point along -g, capped
    t = jnp.minimum(t, (g @ g) / jnp.maximum(g @ (h @ g), 1e-300))
    m_cauchy = -t * (g @ g) + 0.5 * t**2 * (g @ (h @ g))
    return m_tcg, m_trs, m_cauchy, man.norm(x, dx), jnp.linalg.norm(coeff), radius


@pytest.mark.parametrize("mode", ["single", "vmap"])
@pytest.mark.parametrize("case", ["interior", "boundary"])
@pytest.mark.parametrize("structure", sorted(STRUCTURES))
def test_xla_tcg_matches_dense_trs(structure, case, mode):
    """Interior: Hw is positive definite (large barrier weights) and the
    Newton step lies inside the region, so tCG run to a tight tolerance is
    the exact TRS solution.  Boundary: the region is 0.3x the Newton step;
    tCG stops on the boundary with a model value between the TRS optimum
    and the Cauchy point's."""
    build = STRUCTURES[structure]
    radius_scale = 10.0 if case == "interior" else 0.3
    problems = [build(s) for s in range(3)]
    problem = problems[0]
    xs = jnp.stack([p.x0 for p in problems])
    ys = jnp.full((3, problem.num_ineq), 20.0, xs.dtype)
    fn = lambda x, y: _tcg_and_trs(problem, x, y, radius_scale)
    if mode == "vmap":
        out = jax.jit(jax.vmap(fn))(xs, ys)
    else:
        out = [np.stack(v) for v in zip(*[fn(xs[i], ys[i]) for i in range(3)])]
    m_tcg, m_trs, m_cauchy, n_tcg, n_trs, radius = (np.asarray(v) for v in out)
    scale = np.abs(m_trs)
    if case == "interior":
        np.testing.assert_allclose(m_tcg, m_trs, rtol=1e-8)
        np.testing.assert_allclose(n_tcg, n_trs, rtol=1e-6)
        assert np.all(n_trs < radius)
    else:
        np.testing.assert_allclose(n_tcg, radius, rtol=1e-8)
        assert np.all(m_tcg >= m_trs - 1e-10 * scale)
        assert np.all(m_tcg <= m_cauchy + 1e-10 * scale)


def test_gpu_measure_main_refuses_cpu(capsys):
    from riptrm_tpu.experiment import gpu_measure

    with pytest.raises(SystemExit) as exc:
        gpu_measure.main(["unused_dir"])
    assert exc.value.code != 0
    assert capsys.readouterr().out == ""


def test_require_gpus_refuses_cpu(capsys):
    from riptrm_tpu.utils.devices import require_gpus

    with pytest.raises(SystemExit) as exc:
        require_gpus(prog="probe")
    assert exc.value.code == 2
    assert "probe: no GPU" in capsys.readouterr().err
