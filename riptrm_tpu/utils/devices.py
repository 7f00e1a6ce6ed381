"""Device selection helpers."""

from __future__ import annotations

import subprocess
import sys

import jax


def require_gpus(count=None, prog="riptrm_tpu"):
    """The GPU devices JAX sees; exits non-zero when there are none (or
    fewer than ``count``)."""
    devs = jax.devices()
    if devs[0].platform != "gpu":
        sys.stderr.write(f"{prog}: no GPU (JAX platform {devs[0].platform!r})\n")
        raise SystemExit(2)
    if count is not None and len(devs) < count:
        sys.stderr.write(f"{prog}: {len(devs)} GPU(s), need {count}\n")
        raise SystemExit(2)
    return devs


def card_identity() -> str:
    """``name, power.limit`` of every visible card, from nvidia-smi (a
    subprocess that stays off JAX)."""
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60,
    )
    return out.stdout.strip()


def local_cpu():
    """First PROCESS-LOCAL CPU device.

    ``jax.devices('cpu')[0]`` is the first device of the GLOBAL list; in a
    multi-process run (``parallel/distributed.py``) that device may belong
    to another process, and ``device_put`` to it raises
    "Cannot copy array to non-addressable device".  Host-side data
    generation must always pin to an addressable device.
    """
    return jax.local_devices(backend="cpu")[0]
