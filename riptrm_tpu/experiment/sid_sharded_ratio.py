"""Data-sharded vs plain step-time decomposition for large StableIdentification.

The data-sharded StableId HVP step measured 2.97x the plain step time on
the 8-device virtual CPU mesh at d=32 (a 2-vCPU host) — but a virtual
mesh on a small host conflates two very different costs:

* **collective structure** — partition-induced communication/recompute
  that would also be paid on real chips, and
* **host contention** — under SPMD every device executes ALL replicated
  work (the entire solver step except the data contraction), so N virtual
  devices on 2 cores execute the replicated step ~N/2 times serially.
  On real chips this cost is ZERO (devices run in parallel).

This harness separates them with three measurements at fixed work:

1. ``plain``      — unsharded single-device step rate (baseline);
2. ``sharded``    — X/XP sharded over the ``data`` mesh axis (the real
   TP program: collectives + contention);
3. ``replicated`` — the SAME plain step run fully replicated over every
   mesh device with ZERO collectives (pure-contention control: each
   device does all the work, none communicate).

``sharded/plain`` <= ``replicated/plain`` proves the collective structure
adds nothing beyond host contention (the sharded program does strictly
LESS per-device FLOPs than the replicated control).  The harness also
counts collectives statically in the COMPILED (post-SPMD-partitioner)
HLO of the sharded cost/grad/HVP/step, to check the count against the
theoretical minimum — one all-reduce per data contraction:

* cost:  1 (the scalar residual-sum reduction),
* grad:  1 (the reverse-mode ``resid @ X.T`` [d,d] contraction; the
  J/R/Q leaves derive from the reduced A-bar locally),
* HVP:   2 (forward tangent is local; one contraction in each of the
  forward-over-reverse passes).

Run once per virtual device count (the flag must be set before JAX
initializes):

    python -m riptrm_tpu.experiment.sid_sharded_ratio --d 32 \
        --virtual-devices 8 [--skip-collectives]

Generated payloads cache under ``dataset/_cache`` (the d=32 interior
start search costs minutes on this host).
"""

from __future__ import annotations

import argparse
import json
import os
import re
import time

import numpy as np


def _step_rate(jax, jnp, problem, option, st0=None, steps_pair=(4, 20), tries=5):
    from riptrm_tpu.solvers.riptrm import init_state, make_step

    step = make_step(problem, option)
    if st0 is None:
        st0 = init_state(problem, option)

    def make_chain(k):
        def run(st):
            def body(st, _):
                new_st, info = step(st)
                return new_st, info["residual"]

            st, res = jax.lax.scan(body, st, None, length=k)
            return res[-1]

        return jax.jit(run)

    f_s, f_l = make_chain(steps_pair[0]), make_chain(steps_pair[1])
    np.asarray(f_s(st0)), np.asarray(f_l(st0))  # compile both

    def timed(f):
        ts = []
        for _ in range(tries):
            t0 = time.perf_counter()
            np.asarray(f(st0))
            ts.append(time.perf_counter() - t0)
        return min(ts)

    dt = max(timed(f_l) - timed(f_s), 1e-4)
    return (steps_pair[1] - steps_pair[0]) / dt  # steps/s


def _allreduce_latency(jax, jnp, mesh, d, lens=(50, 500), tries=5):
    """Marginal seconds per [d, d] all-reduce on the mesh: a data-dependent
    chain of psums via shard_map, timed at two lengths.  On a virtual CPU
    mesh this is the cross-thread rendezvous cost; on real chips it is the
    collective."""
    from jax.experimental.shard_map import shard_map
    from jax.sharding import PartitionSpec as P

    n = mesh.shape["data"]
    x = jnp.ones((d, d * n), jnp.float32)

    def make_chain(k):
        @jax.jit
        def run(x):
            def local(xloc):
                def body(c, _):
                    s = jax.lax.psum(c, "data")
                    return c + 1e-6 * s, None

                out, _ = jax.lax.scan(body, xloc, None, length=k)
                return out

            return shard_map(
                local, mesh=mesh, in_specs=P(None, "data"),
                out_specs=P(None, "data"),
            )(x)

        return run

    f_s, f_l = make_chain(lens[0]), make_chain(lens[1])
    np.asarray(f_s(x)), np.asarray(f_l(x))

    def timed(f):
        ts = []
        for _ in range(tries):
            t0 = time.perf_counter()
            np.asarray(f(x))
            ts.append(time.perf_counter() - t0)
        return min(ts)

    return max(timed(f_l) - timed(f_s), 1e-7) / (lens[1] - lens[0])


def _mean_tcg_iters(jax, jnp, problem, option, steps=20):
    """Mean HVP calls (tCG iterations) per solver step over a short chain."""
    from riptrm_tpu.solvers.riptrm import init_state, make_step

    step = make_step(problem, option)

    @jax.jit
    def run(st):
        def body(st, _):
            new_st, info = step(st)
            return new_st, info["tcg_iters"]

        _, its = jax.lax.scan(body, st, None, length=steps)
        return its

    its = np.asarray(run(init_state(problem, option)))
    return float(np.mean(its))


_COLLECTIVES = ("all-reduce", "all-gather", "reduce-scatter", "collective-permute")


def _collective_counts(jax, fn, *args):
    """Static collective-instruction counts in the compiled HLO (post
    SPMD partitioning).  Counts are static (a collective inside a
    scan/while body counts once but executes per iteration)."""
    txt = jax.jit(fn).lower(*args).compile().as_text()
    return {
        k: len(re.findall(rf"{k}(?:-start)?\(", txt)) for k in _COLLECTIVES
    }


def _load_or_generate(jax, d, n_trajs, traj_steps, seed):
    from riptrm_tpu.experiment.chip_sweep import _cache_dir
    from riptrm_tpu.problems import stable_identification as si

    cache = _cache_dir() / f"sidratio_d{d}_t{n_trajs}x{traj_steps}_seed{seed}.npz"
    if cache.is_file():
        with np.load(cache) as z:
            return (
                [z["trajs"][i] for i in range(z["trajs"].shape[0])],
                z["constset"], (z["J"], z["R"], z["Q"]), True,
            )
    rng = np.random.default_rng(seed)
    key = jax.random.PRNGKey(seed)
    _, _, _, true_a = si.generate_true_system(key, d)
    constset = si.generate_constraints(rng, d, true_a, 0.2, 0.1)
    trajs = [
        si.generate_trajectory(rng, d, true_a, h=0.02,
                               n_steps=traj_steps, snr=10)[1]
        for _ in range(n_trajs)
    ]
    j0, r0, q0, _ = si.generate_interior_initialpoint_lsq(
        jax.random.PRNGKey(seed + 1), d, constset
    )
    cache.parent.mkdir(parents=True, exist_ok=True)
    np.savez(cache, trajs=np.stack(trajs), constset=np.asarray(constset),
             J=j0, R=r0, Q=q0)
    return trajs, constset, (j0, r0, q0), False


def main(argv=None):
    parser = argparse.ArgumentParser(description=__doc__)
    parser.add_argument("--d", type=int, default=32)
    parser.add_argument("--virtual-devices", type=int, default=8)
    parser.add_argument("--n-trajs", type=int, default=4)
    parser.add_argument("--traj-steps", type=int, default=64)
    parser.add_argument("--seed", type=int, default=0)
    parser.add_argument("--skip-collectives", action="store_true")
    parser.add_argument("--skip-control", action="store_true")
    args = parser.parse_args(argv)

    if args.virtual_devices:
        flags = os.environ.get("XLA_FLAGS", "")
        os.environ["XLA_FLAGS"] = (
            f"{flags} --xla_force_host_platform_device_count="
            f"{args.virtual_devices}"
        )

    from riptrm_tpu.config import setup

    jax = setup(cpu=True, x64=False)
    import jax.numpy as jnp
    from jax.sharding import NamedSharding, PartitionSpec as P

    from riptrm_tpu.parallel.sweep import make_mesh
    from riptrm_tpu.problems import stable_identification as si

    d = args.d
    trajs, constset, x0, cache_hit = _load_or_generate(
        jax, d, args.n_trajs, args.traj_steps, args.seed
    )
    option_dict = {
        "maxiter": 60,
        "tolresid": 3e-4,
        "TRS_solver": "tCG",
        "second_order_stationarity": False,
        "forcing_function_Lagrangian": lambda mu: jnp.maximum(mu, 1e-4),
        "forcing_function_complementarity": (
            lambda mu: jnp.maximum(1e-3 * mu, 2e-4)
        ),
    }
    from riptrm_tpu.solvers.riptrm import RIPTRM, init_state

    option = RIPTRM(option_dict).option

    plain = si.make_problem(d, trajs, constset, x0, dtype=jnp.float32)
    mesh = make_mesh({"data": args.virtual_devices})
    sharded = si.make_problem(d, trajs, constset, x0,
                              dtype=jnp.float32, mesh=mesh,
                              data_axis="data")

    rate_plain = _step_rate(jax, jnp, plain, option)
    rate_sharded = _step_rate(jax, jnp, sharded, option)
    out = {
        "d": d,
        "dim": int(plain.manifold.dim),
        "data_cols": int(args.n_trajs * (args.traj_steps - 1)),
        "virtual_devices": args.virtual_devices,
        "cache_hit": cache_hit,
        "plain_steps_per_s": round(rate_plain, 2),
        "sharded_steps_per_s": round(rate_sharded, 2),
        "sharded_over_plain_step_time": round(rate_plain / rate_sharded, 3),
        "device": "virtual-cpu-mesh",
    }

    if not args.skip_control:
        # Pure-contention control: the plain step replicated on EVERY mesh
        # device (zero collectives, full per-device work).  Placing the
        # initial state with a fully-replicated NamedSharding makes jit
        # compile the single-device program for the whole mesh.
        rep_spec = NamedSharding(mesh, P())
        st0 = jax.device_put(init_state(plain, option), rep_spec)
        rate_repl = _step_rate(jax, jnp, plain, option, st0=st0)
        out["replicated_steps_per_s"] = round(rate_repl, 2)
        out["replicated_over_plain_step_time"] = round(
            rate_plain / rate_repl, 3
        )
        out["contention_explains_overhead"] = bool(
            rate_sharded * 1.05 >= rate_repl  # 5% measurement slack
        )

    if not args.skip_collectives:
        x = sharded.x0
        y = jnp.ones((sharded.num_ineq,), jnp.float32)
        g = sharded.lag_rgrad(x, y)  # also the HVP direction (x-like tree)
        out["collectives"] = {
            "cost": _collective_counts(jax, sharded.cost, x),
            "grad": _collective_counts(
                jax, lambda x_: sharded.lag_rgrad(x_, y), x
            ),
            "hvp": _collective_counts(
                jax, lambda x_, v_: sharded.lag_rhess(x_, y, v_), x, g
            ),
        }
        # Full decomposition: measured per-collective rendezvous latency x
        # dynamic collective count per step vs the measured overhead.
        from riptrm_tpu.solvers.riptrm import init_state, make_step

        step_txt = (
            jax.jit(make_step(sharded, option))
            .lower(init_state(sharded, option)).compile().as_text()
        )
        static_sites = len(re.findall(r"all-reduce(?:-start)?\(", step_txt))
        lat = _allreduce_latency(jax, jnp, mesh, d)
        tcg_mean = _mean_tcg_iters(jax, jnp, plain, option)
        overhead_s = 1.0 / rate_sharded - 1.0 / rate_plain
        dyn = tcg_mean + (static_sites - 1)  # 1 site lives in the tCG body
        out["static_allreduce_sites_per_step"] = static_sites
        out["allreduce_latency_us"] = round(lat * 1e6, 1)
        out["mean_tcg_iters_per_step"] = round(tcg_mean, 1)
        out["dynamic_allreduces_per_step"] = round(dyn, 1)
        out["overhead_ms_per_step"] = round(overhead_s * 1e3, 3)
        out["effective_us_per_allreduce"] = round(overhead_s / dyn * 1e6, 1)
        out["implied_barriers_per_step"] = round(overhead_s / lat, 1)

    print(json.dumps(out))


if __name__ == "__main__":
    main()
