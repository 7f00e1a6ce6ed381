"""Worker process for the 2-process jax.distributed test.

Spawned by tests/test_distributed.py: each process owns 2 virtual CPU
devices (4 global), wires jax.distributed through
``riptrm_tpu.parallel.distributed.initialize``, and runs one cross-process
``sharded_riptrm_solve`` over the global dp mesh — the in-process analog of
the reference's Hydra-multirun process fan-out
(``/root/reference/README.md:72-107``) with the batch axis spanning hosts.

Usage: python distributed_worker.py <pid> <nproc> <coordinator> <out.json>
"""

import json
import os
import sys


def main():
    pid, nproc = int(sys.argv[1]), int(sys.argv[2])
    addr, out_path = sys.argv[3], sys.argv[4]

    flags = os.environ.get("XLA_FLAGS", "")
    os.environ["XLA_FLAGS"] = (
        flags + " --xla_force_host_platform_device_count=2"
    ).strip()
    from riptrm_tpu.config import setup

    jax = setup(cpu=True, x64=True)

    from riptrm_tpu.parallel import distributed

    distributed.initialize(
        coordinator_address=addr, num_processes=nproc, process_id=pid
    )
    assert jax.process_count() == nproc, jax.process_count()
    assert jax.device_count() == 2 * nproc, jax.device_count()

    import numpy as np
    import jax.numpy as jnp
    from jax.sharding import NamedSharding, PartitionSpec as P

    from riptrm_tpu.parallel.distributed import host_shard
    from riptrm_tpu.parallel.sweep import make_mesh, sharded_riptrm_solve
    from riptrm_tpu.problems import nonneg_pca

    mine = host_shard(list(range(7)))

    # Global dp mesh spanning BOTH processes' devices.
    mesh = make_mesh({"dp": jax.device_count()})

    n, batch = 16, 8
    k1, k2 = jax.random.split(jax.random.PRNGKey(0))
    data = nonneg_pca.generate_instance(k1, n)
    xs = np.abs(np.asarray(jax.random.normal(k2, (batch, n))))
    xs = xs / np.linalg.norm(xs, axis=1, keepdims=True)
    ys = np.ones((batch, n))
    problem = nonneg_pca.make_problem(np.asarray(data["Z"]), xs[0])
    option = {
        "maxiter": 12,
        "tolresid": 1e-7,
        "TRS_solver": "tCG",
        "second_order_stationarity": False,
    }

    fn = sharded_riptrm_solve(problem, option, max_steps=300, mesh=mesh)
    sh = NamedSharding(mesh, P("dp", None))
    gx = jax.make_array_from_callback(
        (batch, n), sh, lambda idx: jnp.asarray(xs[idx])
    )
    gy = jax.make_array_from_callback(
        (batch, n), sh, lambda idx: jnp.asarray(ys[idx])
    )
    _, _, _, res_all = fn(gx, gy)
    # out_specs P(): the residual vector is replicated on every device, so
    # every PROCESS can act on the global convergence stats.
    res = np.asarray(res_all)

    with open(out_path, "w") as f:
        json.dump(
            {
                "pid": pid,
                "process_count": jax.process_count(),
                "device_count": jax.device_count(),
                "local_devices": len(jax.local_devices()),
                "host_shard": mine,
                "residuals": [float(r) for r in res],
            },
            f,
        )


if __name__ == "__main__":
    main()
