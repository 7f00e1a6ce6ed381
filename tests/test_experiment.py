"""Experiment-layer tests: config, sweep expansion, simulate/generate CLIs,
CSV contract, analyzer."""

import os
import pathlib

import numpy as np
import pandas as pd
import pytest

from riptrm_tpu.experiment.cfg import load_config, solver_options_from_cfg, sweep_configs

REPO_ROOT = pathlib.Path(__file__).resolve().parents[1]


def test_config_interpolation(tmp_path):
    p = tmp_path / "c.yaml"
    p.write_text(
        "problem_name: Foo\nproblem_instance: 3\n"
        "output_path: intermediate/${problem_name}/${problem_instance}\n"
        "tol: 1e-8\n"
    )
    cfg = load_config(str(p))
    assert cfg.output_path == "intermediate/Foo/3"
    assert cfg.tol == 1e-8  # YAML-1.1 '1e-8' string coerced to float


def test_config_overrides(tmp_path):
    p = tmp_path / "c.yaml"
    p.write_text("a: 1\nnested:\n  b: 2\n")
    cfg = load_config(str(p), ["a=5", "nested.b=7", "new.key=hello"])
    assert cfg.a == 5 and cfg.get_path("nested.b") == 7
    assert cfg.get_path("new.key") == "hello"


def test_sweep_cross_product(tmp_path):
    p = tmp_path / "c.yaml"
    p.write_text(
        "problem_name: X\nsweeper:\n  params:\n    inst: 1,2,3\n    pt: a,b\n"
    )
    cfgs = sweep_configs(str(p))
    assert len(cfgs) == 6
    combos = {(c.inst, c.pt) for c in cfgs}
    assert combos == {(i, p_) for i in (1, 2, 3) for p_ in ("a", "b")}


def test_sweep_interpolation_after_sweep_values(tmp_path):
    """Regression: ${...} paths must reflect the swept value of each job,
    not the config default (all jobs once wrote to the same directory)."""
    p = tmp_path / "c.yaml"
    p.write_text(
        "problem_name: X\npt: a\nout: inter/${pt}\n"
        "sweeper:\n  params:\n    pt: a,b,c\n"
    )
    cfgs = sweep_configs(str(p))
    assert sorted(c.out for c in cfgs) == ["inter/a", "inter/b", "inter/c"]


def test_sweep_cli_override_axis(tmp_path):
    p = tmp_path / "c.yaml"
    p.write_text("problem_name: X\n")
    cfgs = sweep_configs(str(p), ["pt=a,b,c"])
    assert len(cfgs) == 3


def test_sweep_single_value_pins_axis(tmp_path):
    """A single-value CLI override of a sweep axis pins it to that value
    (Hydra semantics) instead of being clobbered by the sweep expansion."""
    p = tmp_path / "c.yaml"
    p.write_text(
        "problem_name: X\nsweeper:\n  params:\n    pt: a,b,c\n    inst: 1,2\n"
    )
    cfgs = sweep_configs(str(p), ["pt=b"])
    assert len(cfgs) == 2
    assert all(c.pt == "b" for c in cfgs)
    assert sorted(c.inst for c in cfgs) == [1, 2]


def test_solver_option_merge():
    cfg = load_config("configs/NonnegPCA/config_simulation.yaml")
    opt = solver_options_from_cfg(cfg, "RIPTRM")
    assert opt["maxtime"] == 240
    assert opt["TRS_solver"] == "tCG"
    assert opt["second_order_stationarity"] is False
    opt2 = solver_options_from_cfg(cfg, "RSQO")
    assert opt2["quadoptim_eigvalcorr"] == 1e-2


def test_simulate_end_to_end(tmp_path, monkeypatch):
    """Full pipeline on the golden instance with a tiny budget."""
    monkeypatch.chdir(REPO_ROOT)
    from riptrm_tpu.experiment.simulator import main

    out_dir = str(tmp_path / "out")
    main(
        [
            "--problem",
            "NonnegPCA",
            "solver_name=[RIPTRM]",
            "solver_option.common.maxtime=30",
            "solver_option.common.maxiter=3",
            "solver_option.common.tolresid=1e-8",
            f"output_path={out_dir}",
        ]
    )
    df = pd.read_csv(f"{out_dir}/RIPTRM_tCG_log.csv")
    assert df["residual"].iloc[-1] < df["residual"].iloc[0]
    x = np.loadtxt(f"{out_dir}/RIPTRM_tCG_x.csv")
    assert abs(np.linalg.norm(x) - 1) < 1e-10
    assert os.path.exists(f"{out_dir}/RIPTRM_tCG_option.csv")


def test_generate_and_solve_roundtrip(tmp_path, monkeypatch):
    monkeypatch.chdir(REPO_ROOT)
    from riptrm_tpu.experiment.generate import main

    out = str(tmp_path / "ds")
    main(["--problem", "NonnegPCA", "dim=12", f"output_path={out}"])
    from riptrm_tpu.problems import nonneg_pca

    p = nonneg_pca.load_problem(out, "a")
    assert p.num_ineq == 12
    g = np.asarray(p.ineq_val(p.x0))
    assert (g <= 0).all()


def test_generate_and_load_low_rank(tmp_path, monkeypatch):
    monkeypatch.chdir(REPO_ROOT)
    from riptrm_tpu.experiment.generate import main

    out = str(tmp_path / "ds")
    main(["--problem", "LowRank", "m=7", "n=5", "rank=2", f"output_path={out}"])
    from riptrm_tpu.problems import low_rank

    p = low_rank.load_problem(out, "a")
    assert p.num_ineq == 35
    assert (np.asarray(p.slack(p.x0)) > 0).all()  # strictly feasible start
    u, s, v = p.x0
    assert u.shape == (7, 2) and s.shape == (2,) and v.shape == (5, 2)


def test_block_file_roundtrip(tmp_path):
    from riptrm_tpu.experiment.simulator import load_block_file, save_output
    from riptrm_tpu.solvers.base import Output

    j = np.arange(9.0).reshape(3, 3)
    r = np.eye(3)
    out = Output(name="T", x=(j, r), ineqLagmult=np.ones(2), eqLagmult=np.zeros(0), option={"a": 1}, log={"b": [1, 2]})
    save_output(str(tmp_path), "T", out)
    blocks = load_block_file(str(tmp_path / "T_x.csv"))
    np.testing.assert_allclose(blocks[0], j)
    np.testing.assert_allclose(blocks[1], r)


def test_analyzer_filters_and_best(tmp_path):
    from riptrm_tpu.experiment.analyzer import best_residual_within, filter_riptrm_rows

    df = pd.DataFrame(
        {
            "time": [0.0, 1.0, 2.0, 3.0, 250.0],
            "residual": [1.0, 0.5, 0.1, 0.2, 1e-9],
            "inner_status": [np.nan, "successful", "converged", "unsuccessful", "converged"],
        }
    )
    f = filter_riptrm_rows(df)
    assert list(f["time"]) == [0.0, 2.0, 250.0]
    assert best_residual_within(f, 240.0) == 0.1


def test_analyzer_plots_from_synthetic_logs(tmp_path):
    """The three analyzer plot kinds render and save from the CSV log
    contract (reference notebooks: residual curves, arctan second-order
    curves, best-residual box plots)."""
    import pandas as pd

    from riptrm_tpu.experiment.analyzer import (
        box_plot_best_residuals,
        plot_residual_curves,
        plot_second_order_curves,
    )

    for pt in ("a", "b"):
        d = tmp_path / "P" / "1" / pt
        d.mkdir(parents=True)
        n = 30
        pd.DataFrame({
            "iteration": range(n),
            "time": [0.1 * i for i in range(n)],
            "residual": [10.0 * 0.7**i for i in range(n)],
            "second_order_residual": [(-1) ** i * 0.5**i for i in range(n)],
            "inner_status": ["converged"] * n,
        }).to_csv(d / "RIPTRM_tCG_log.csv", index=False)

    out_dir = str(tmp_path / "P" / "1" / "a")
    f1 = str(tmp_path / "res.png")
    plot_residual_curves(out_dir, ["RIPTRM_tCG"], save_path=f1)
    f2 = str(tmp_path / "so.png")
    plot_second_order_curves(out_dir, ["RIPTRM_tCG"], save_path=f2)
    f3 = str(tmp_path / "box.png")
    box_plot_best_residuals(
        str(tmp_path / "P"), 1, ["a", "b"], ["RIPTRM_tCG"], save_path=f3
    )
    import os

    assert all(os.path.getsize(f) > 1000 for f in (f1, f2, f3))


def test_strict_complementarity_checker(tmp_path):
    """strict_complementarity flags exactly the indices where |y_i| and
    |g_i(x)| are both ~0 (reference
    analyzer_strict_complementarity.py:51-68), and the output post-checker
    parses block-format x CSVs."""
    import numpy as np

    from riptrm_tpu.experiment.analyzer import (
        check_strict_complementarity_outputs,
        strict_complementarity,
    )
    from riptrm_tpu.problems import stable_identification as si

    path = "dataset/StableIdentification/1"
    problem = si.load_problem(path, "a")
    x = problem.x0
    g = np.asarray(problem.ineq_val(x))
    # y chosen so index 0 violates strict complementarity iff g[0] ~ 0;
    # make every y_i large except one paired with a tiny slack we inject
    y = np.ones(problem.num_ineq)
    near = int(np.argmin(np.abs(g)))
    y[near] = 0.0
    idx = strict_complementarity(problem, x, y, tol=np.abs(g[near]) + 1e-12)
    assert near in idx
    y[near] = 1.0
    assert strict_complementarity(problem, x, y, tol=1e-12).size == 0

    # post-checker over saved outputs (block-format x via save_output)
    out_dir = tmp_path / "1" / "a"
    out_dir.mkdir(parents=True)
    from riptrm_tpu.experiment.simulator import save_output
    from riptrm_tpu.solvers.base import Output

    save_output(
        str(out_dir),
        "S",
        Output(
            name="S",
            x=tuple(np.asarray(l) for l in x),
            ineqLagmult=y,
            eqLagmult=np.zeros(0),
            option={},
            log={},
        ),
    )
    res = check_strict_complementarity_outputs(
        path, str(tmp_path), 1, ["a"], ["S"]
    )
    assert ("S", "a") in res
    assert res[("S", "a")].size == 0
