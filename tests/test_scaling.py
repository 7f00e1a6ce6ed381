"""Weak-scaling harness (experiment/scaling.py) on the virtual CPU mesh."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from riptrm_tpu.experiment.scaling import measure, sweep_rate
from riptrm_tpu.parallel.sweep import make_mesh
from riptrm_tpu.problems import nonneg_pca


@pytest.fixture(scope="module")
def small_problem():
    k1, k2 = jax.random.split(jax.random.PRNGKey(0))
    data = nonneg_pca.generate_instance(k1, 32)
    x0 = np.abs(np.asarray(jax.random.normal(k2, (32,))))
    x0 /= np.linalg.norm(x0)
    return nonneg_pca.make_problem(data["Z"], x0)


OPTION = {
    "maxiter": 40,
    "tolresid": 1e-5,
    "TRS_solver": "tCG",
    "second_order_stationarity": False,
}


def test_sweep_rate_runs_and_converges(small_problem):
    mesh = make_mesh({"dp": 2}, jax.devices()[:2])
    rate, med, mx = sweep_rate(
        small_problem, OPTION, mesh, batch=4, max_steps=200, reps=2
    )
    assert rate > 0
    assert np.isfinite(med) and np.isfinite(mx)
    assert mx < 1e-3  # every lane reaches near the requested tolerance


def test_measure_weak_scaling_rows(small_problem):
    rows = measure(
        small_problem,
        OPTION,
        device_counts=[1, 2],
        per_device=2,
        max_steps=200,
        reps=2,
    )
    assert [r["devices"] for r in rows] == [1, 2]
    assert rows[0]["efficiency"] == 1.0
    assert rows[1]["batch"] == 4
    assert rows[1]["solves_per_sec"] > 0
    # 2 virtual CPU devices on 2 vCPUs: no perf claim, just a sane ratio
    assert 0 < rows[1]["efficiency"] < 10
