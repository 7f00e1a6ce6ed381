"""Multi-host initialization and sweep sharding.

The reference has no distributed backend (SURVEY.md §2.3) — its scale-out
is Hydra multirun forking OS processes.  Scale-out here:

* ``initialize()`` wires ``jax.distributed`` (device interconnect within
  a host, the network across hosts); call once per host process before any computation.
* ``host_shard(items)`` splits sweep work (instance x initial-point x
  solver jobs) across hosts for host-driven runs — coarse-grained DP over
  DCN, matching the multirun semantics with no cross-host chatter.
* For in-graph sharding, build a global mesh with
  ``riptrm_tpu.parallel.sweep.make_mesh`` over ``jax.devices()`` (all
  hosts' devices) and use ``sharded_riptrm_solve``.
"""

from __future__ import annotations

from typing import Optional, Sequence

import jax


def initialize(
    coordinator_address: Optional[str] = None,
    num_processes: Optional[int] = None,
    process_id: Optional[int] = None,
) -> None:
    """Initialize jax.distributed (no-op when single-process)."""
    if num_processes is None or num_processes <= 1:
        return
    jax.distributed.initialize(
        coordinator_address=coordinator_address,
        num_processes=num_processes,
        process_id=process_id,
    )


def host_shard(items: Sequence, process_id: Optional[int] = None, num: Optional[int] = None):
    """Deterministic round-robin split of sweep jobs across host processes."""
    pid = jax.process_index() if process_id is None else process_id
    n = jax.process_count() if num is None else num
    return [item for i, item in enumerate(items) if i % n == pid]
