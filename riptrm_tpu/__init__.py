"""riptrm_tpu — an accelerator-native framework for Riemannian inequality-constrained optimization.

A from-scratch JAX/XLA re-design (NOT a port) of the capabilities of
shirokumakur0/Riemannian-interior-point-trust-region-method:

- ``manifolds``: manifolds as modules of pure, jittable functions over pytrees
  (sphere, Grassmann, SPD, skew-symmetric, Euclidean, product) with
  *deterministic closed-form orthonormal tangent bases* (the reference builds
  random bases via Gram-Schmidt; ``/root/reference/src/solver/utils.py:388-397``).
- ``problems``: constrained problems with *stacked* constraint functions
  ``g: M -> R^m`` differentiated by JAX transforms (the reference keeps one
  autograd closure per constraint; ``utils.py:33-203``).
- ``solvers``: RIPTRM (primal-dual interior-point trust-region; the paper's
  method), RIPM, RSQO, RALM — each as a pure ``step`` function usable both from
  a host-driven wall-clock loop and inside ``lax.while_loop`` for fully
  compiled, vmappable solves.
- ``ops``: tangent-space linear algebra (batched basis materialization,
  truncated CG, Moré-Sorensen TRS, conjugate residual, a jittable QP IPM,
  spectra).
- ``experiment``: config / generator / simulator / analyzer / benchmark
  pipeline preserving the reference's CSV dataset contract, plus
  checkpoint/resume.
- ``parallel``: vmap + shard_map sweep execution over device meshes and
  multi-host job sharding.
"""

from riptrm_tpu import config, manifolds, ops, parallel, problems, solvers  # noqa: F401
from riptrm_tpu.problems import Problem  # noqa: F401
from riptrm_tpu.solvers import RALM, RIPM, RIPTRM, RSQO  # noqa: F401

__version__ = "0.1.0"

__all__ = [
    "config",
    "manifolds",
    "ops",
    "parallel",
    "problems",
    "solvers",
    "Problem",
    "RALM",
    "RIPM",
    "RIPTRM",
    "RSQO",
]
