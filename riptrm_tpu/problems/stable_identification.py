"""Stable LTI system identification on Product(SkewSymmetric, SPD, SPD).

x = (J, R, Q); A = (J - R) Q must be stable; cost is the one-step
prediction error over concatenated trajectories.

Parity targets: ``/root/reference/src/StableIdentification/coordinator.py``
(manifold :34-46, cost :49-100, constraints from constset.csv :102-152),
``generator.py`` (true system :57-66, constraint synthesis :68-113,
trajectory simulation with AWGN :115-135, RALM-based interior initial
points :137-223) and ``simulator.py`` (skew/symmetry/PD manifold violation
:11-33).

Design: the heterogeneous constraint list (onebox pairs + twobox
quadratics) becomes ONE stacked function driven by per-constraint
kind/row/col/param arrays gathered from A — ordering identical to the
reference's append order so multipliers align for parity checks.
"""

from __future__ import annotations

import math

import jax
import jax.numpy as jnp
import numpy as np

from riptrm_tpu.manifolds import Product, SkewSymmetric, SymmetricPositiveDefinite
from riptrm_tpu.problems.problem import Problem
from riptrm_tpu.utils.io import loadtxt

from riptrm_tpu.utils.devices import local_cpu

KIND_LS = 0  # -A[r,c] + p1 <= 0
KIND_RS = 1  # A[r,c] - p2 <= 0
KIND_TWO = 2  # -(A[r,c] - p1)^2 + p2^2 <= 0


def parse_constset(constset, interior_scaling: float = 1.0):
    """Expand constset rows into per-constraint arrays, preserving the
    reference's append order (``coordinator.py:132-152``).

    Each constset row: [type, row, col, p3, p4, (Aval)].
    type 0/1 -> onebox pair (ls then rs); type 2 -> twobox single.
    ``interior_scaling`` reproduces the generator's tightened constraints
    (``generator.py:274-292``).
    """
    constset = np.atleast_2d(np.asarray(constset))
    kinds, rows, cols, p1s, p2s = [], [], [], [], []
    for row in constset:
        t = int(row[0])
        r, c = int(row[1]), int(row[2])
        if t in (0, 1):
            ls = row[3] * interior_scaling
            rs = row[4] * interior_scaling
            kinds += [KIND_LS, KIND_RS]
            rows += [r, r]
            cols += [c, c]
            p1s += [ls, 0.0]
            p2s += [0.0, rs]
        elif t == 2:
            cc = row[3]
            k = row[4] * (1.0 + (1.0 - interior_scaling))
            kinds.append(KIND_TWO)
            rows.append(r)
            cols.append(c)
            p1s.append(cc)
            p2s.append(k)
        else:
            raise ValueError(f"Invalid constraint type {t}")
    return (
        np.asarray(kinds, dtype=np.int32),
        np.asarray(rows, dtype=np.int32),
        np.asarray(cols, dtype=np.int32),
        np.asarray(p1s),
        np.asarray(p2s),
    )


def _split_xxp(x_full):
    return x_full[:, :-1], x_full[:, 1:]


def make_problem(
    d: int,
    x_trajs,  # list of [d, N] trajectory arrays
    constset,
    x0,  # (J, R, Q) tuple
    y0=None,
    h: float = 0.02,
    interior_scaling: float = 1.0,
    cost_zero: bool = False,
    dtype=None,
    mesh=None,
    data_axis: str = "tp",
    matmul_precision=None,
) -> Problem:
    """Build the StableIdentification problem.

    ``matmul_precision``: None uses the backend default; 'highest' forces
    full-f32 passes through the cost/constraint matmul chain — the
    staged-precision phase-2 program for f32 sweeps (the same lever as
    NonnegPCA's).

    ``mesh``/``data_axis``: shard the concatenated trajectory data over a
    mesh axis (BASELINE north star: "large StableIdentification instances
    additionally shard the HVP matvec").  The cost contracts the [d, N]
    data columns, so placing X/XP with ``NamedSharding(mesh, P(None,
    data_axis))`` partitions every cost/gradient/HVP evaluation across the
    axis — XLA inserts the final ``psum`` over the residual reduction; the
    (J, R, Q) iterate stays replicated.  Column counts that do not divide
    the axis size are zero-padded (exact: an all-zero (x, x') column pair
    contributes 0 to the residual sum, and the 1/N normalization uses the
    true count).
    """
    man = Product(
        [SkewSymmetric(d), SymmetricPositiveDefinite(d), SymmetricPositiveDefinite(d)]
    )
    if not x_trajs and not cost_zero:
        raise ValueError(
            "make_problem got no trajectories with cost_zero=False: the "
            "least-squares cost would be 0/0 = NaN under jit; pass "
            "cost_zero=True for pure feasibility problems"
        )
    xs, xps = [], []
    for xt in x_trajs:
        a, b = _split_xxp(np.asarray(xt))
        xs.append(a)
        xps.append(b)
    X = jnp.asarray(np.hstack(xs), dtype=dtype) if xs else jnp.zeros((d, 0), dtype=dtype)
    XP = jnp.asarray(np.hstack(xps), dtype=dtype) if xps else jnp.zeros((d, 0), dtype=dtype)
    n_cols = X.shape[1]
    data_sharding = None
    if mesh is not None and n_cols:
        from jax.sharding import NamedSharding, PartitionSpec as P

        axis_size = mesh.shape[data_axis]
        pad = (-n_cols) % axis_size
        if pad:
            X = jnp.pad(X, ((0, 0), (0, pad)))
            XP = jnp.pad(XP, ((0, 0), (0, pad)))
        data_sharding = NamedSharding(mesh, P(None, data_axis))
        X = jax.device_put(X, data_sharding)
        XP = jax.device_put(XP, data_sharding)

    def _pin(arr):
        """Re-pin the data sharding IN-GRAPH.  ``jax.jit`` does NOT honor
        the committed sharding of closure-captured constants — it folds
        them into a single-device program (measured round 5: the compiled
        "sharded" cost carried the full [d, N] array, zero collectives,
        num_partitions unset).  A ``with_sharding_constraint`` at the use
        site forces the SPMD partitioner to compile for the mesh, so every
        jitted cost/grad/HVP genuinely partitions the trajectory
        contraction and inserts the psum."""
        if data_sharding is None:
            return arr
        return jax.lax.with_sharding_constraint(arr, data_sharding)

    kinds, rows, cols, p1s, p2s = parse_constset(constset, interior_scaling)
    kinds_j = jnp.asarray(kinds)
    rows_j = jnp.asarray(rows)
    cols_j = jnp.asarray(cols)
    p1_j = jnp.asarray(p1s, dtype=dtype)
    p2_j = jnp.asarray(p2s, dtype=dtype)
    m = len(kinds)

    eye = jnp.eye(d, dtype=dtype)

    def _mm(a, b):
        return jnp.matmul(a, b, precision=matmul_precision)

    def cost(x):
        J, R, Q = x
        if cost_zero:
            # feasibility problem used by the initial-point generator
            # (generator.py:238-243); tiny quadratic keeps AD well-defined
            return 0.0 * jnp.sum(J**2)
        A = _mm(J - R, Q)
        Xs, XPs = _pin(X), _pin(XP)
        resid = XPs - _mm(eye + h * A, Xs)
        return jnp.sum(resid * resid) / n_cols

    def ineq(x):
        J, R, Q = x
        A = _mm(J - R, Q)
        a = A[rows_j, cols_j]
        ls_val = -a + p1_j
        rs_val = a - p2_j
        two_val = -((a - p1_j) ** 2) + p2_j**2
        return jnp.where(
            kinds_j == KIND_LS, ls_val, jnp.where(kinds_j == KIND_RS, rs_val, two_val)
        )

    def manvio(x):
        # simulator.py:11-33
        J, R, Q = x
        v = (
            jnp.linalg.norm(J + J.T)
            + jnp.linalg.norm(R - R.T)
            + jnp.linalg.norm(Q - Q.T)
        )
        pd_ok = (jnp.min(jnp.linalg.eigvalsh(0.5 * (R + R.T))) > 0) & (
            jnp.min(jnp.linalg.eigvalsh(0.5 * (Q + Q.T))) > 0
        )
        return jnp.where(pd_ok, v, jnp.inf)

    x0 = tuple(jnp.asarray(a, dtype=dtype) for a in x0)
    if y0 is None:
        y0 = jnp.ones((m,), dtype=x0[0].dtype)
    else:
        y0 = jnp.asarray(y0, dtype=x0[0].dtype)

    return Problem(
        manifold=man,
        cost=cost,
        ineq=ineq,
        x0=x0,
        y0=y0,
        z0=jnp.zeros((0,), dtype=x0[0].dtype),
        num_ineq=m,
        num_eq=0,
        manvio=manvio,
    )


def load_problem(
    dataset_path: str,
    initialpoint: str = "a",
    x_set=(1, 2, 3, 4, 5),
    is_x_noisy: bool = True,
    h: float = 0.02,
    dtype=None,
) -> Problem:
    """Load a shipped instance (``coordinator.py:14-179``)."""
    d = int(loadtxt(f"{dataset_path}/dim.csv"))
    prefix = "noisyX" if is_x_noisy else "X"
    x_trajs = [loadtxt(f"{dataset_path}/{prefix}_{i}.csv") for i in x_set]
    constset = loadtxt(f"{dataset_path}/constset.csv")
    x0 = (
        loadtxt(f"{dataset_path}/initJ_{initialpoint}.csv"),
        loadtxt(f"{dataset_path}/initR_{initialpoint}.csv"),
        loadtxt(f"{dataset_path}/initQ_{initialpoint}.csv"),
    )
    y0 = loadtxt(f"{dataset_path}/initineqLagmult.csv")
    return make_problem(d, x_trajs, constset, x0, y0, h=h, dtype=dtype)


# ----------------------------------------------------------------------
# Dataset generation (generator.py parity)
# ----------------------------------------------------------------------
def _cpu_key(key):
    """Data generation runs on the host CPU backend, so a seed gives
    bit-identical instances on every machine: a device-resident key would
    pull every split/draw onto the default device."""
    import jax

    return jax.device_put(key, local_cpu())


def generate_true_system(key, d: int, scaling: float = 1.0):
    """``generate_trueJRQA`` (generator.py:57-66)."""
    import jax

    man = Product([SkewSymmetric(d), SymmetricPositiveDefinite(d), SymmetricPositiveDefinite(d)])
    sqrt_s = math.sqrt(scaling)
    with jax.default_device(local_cpu()):
        J, R, Q = man.random_point(_cpu_key(key))
        J, R, Q = sqrt_s * J, sqrt_s * R, sqrt_s * Q
        A = (J - R) @ Q
    return np.asarray(J), np.asarray(R), np.asarray(Q), np.asarray(A)


def generate_constraints(rng, d: int, true_A, oneboxratio: float,
                         twoboxratio: float, min_segment_width=None,
                         max_redraws: int = 50):
    """``generate_constraints`` (generator.py:68-113).  Uses numpy RNG on the
    host — dataset generation is not a hot path.

    ``min_segment_width`` (extension; round-5 d=32 finding): every
    constraint width scales with |true_A[r, c]|, so a near-zero true-A
    entry gets a RAZOR-thin box (measured d=32: onebox width down to
    1.9e-3 against a median 0.87, a 2,324x spread across entries) whose
    barrier conditioning (~1e12) floors every solver near the corridor
    width (the 3.6e-3 x64 CPU floor, result/sid32_cpu_deep.jsonl, is
    ~2x the tightest corridor, result/sid32_margins.json).  Setting a floor (a) only constrains entries with
    |true_A[r, c]| >= 2.5 * min_segment_width (a onebox width is at
    least 0.4|a|), and (b) redraws twobox parameters until the widest
    remaining segment clears the floor — a documented well-margined
    VARIANT, NOT the reference generator (which never filters,
    ``generator.py:68-113``)."""
    true_A = np.asarray(true_A)
    num_element = true_A.size
    num_onebox = int(num_element * oneboxratio)
    num_twobox = int(num_element * twoboxratio)
    num_const = num_onebox + num_twobox
    perm = rng.permutation(num_element)
    if min_segment_width is not None:
        flat_abs = np.abs(true_A.T.reshape(-1))  # index i -> (i % d, i // d)
        perm = perm[flat_abs[perm] >= 2.5 * min_segment_width]
        if len(perm) < num_const:
            raise ValueError(
                f"min_segment_width={min_segment_width}: only {len(perm)} "
                f"of {num_element} entries have |A| >= "
                f"{2.5 * min_segment_width:.3g}; need {num_const}"
            )
    constindices = perm[:num_const]
    rowcol = np.stack([constindices % d, constindices // d], axis=1)

    def _twobox_width(ls, rs, cc, k):
        """Widest feasible segment of [ls, rs] minus the |a-cc| < |k| hole."""
        half = abs(k)
        segs = [(ls, min(rs, cc - half)), (max(ls, cc + half), rs)]
        return max((b - a for a, b in segs if b > a), default=0.0)

    constset = []
    for i in range(num_onebox):
        r, c = rowcol[i]
        aval = true_A[r, c]
        absa = abs(aval)
        ls = aval - rng.uniform(0.2, 0.8) * absa
        rs = aval + rng.uniform(0.2, 0.8) * absa
        constset.append([0, r, c, ls, rs, aval])
    for i in range(num_onebox, num_const):
        r, c = rowcol[i]
        aval = true_A[r, c]
        absa = abs(aval)
        for _ in range(max_redraws if min_segment_width else 1):
            cc = rng.uniform(0.2, 0.8) * aval
            k = cc + rng.uniform(0.2, 0.8) * (aval - cc)
            ls = -absa - rng.uniform(0.2, 0.8) * absa
            rs = absa + rng.uniform(0.2, 0.8) * absa
            if (
                min_segment_width is None
                or _twobox_width(ls, rs, cc, k) >= min_segment_width
            ):
                break
        constset.append([1, r, c, ls, rs, aval])
        constset.append([2, r, c, cc, k, aval])
    return np.asarray(constset)


def _awgn(rng, signal, snr_db):
    power = np.mean(np.abs(signal) ** 2)
    noise_power = power / (10 ** (snr_db / 10))
    return signal + np.sqrt(noise_power) * rng.standard_normal(signal.shape)


def generate_trajectory(rng, d: int, true_A, h: float, n_steps: int, snr: float):
    """``generate_XnoisyX`` (generator.py:122-135).  NOTE: the reference
    applies *elementwise* ``np.exp`` to ``i*h*A`` (not a matrix
    exponential); we reproduce that data-generating process exactly."""
    x0 = -1000 + 2000 * rng.random(d)
    X = np.zeros((d, n_steps))
    noisyX = np.zeros((d, n_steps))
    X[:, 0] = x0
    noisyX[:, 0] = _awgn(rng, x0, snr)
    for i in range(1, n_steps):
        expAh = np.exp(i * h * np.asarray(true_A))
        X[:, i] = expAh @ x0
        noisyX[:, i] = _awgn(rng, X[:, i], snr)
    X = X / np.linalg.norm(x0)
    noisyX = noisyX / np.linalg.norm(noisyX[:, 0])
    return X, noisyX


def feasible_entry_targets(constset):
    """Per constrained entry of A, a strictly feasible target value.

    Each entry's feasible set is an interval [lo, hi] (onebox / twobox box
    rows) minus annulus holes (twobox quadratic rows, |a - cc| >= k); the
    target is the midpoint of the widest remaining segment — strictly
    interior with margin = half the segment width.  Built from the
    ORIGINAL constraint parameters (the generator's interior_scaling
    "tightening" multiplies bounds toward zero, which *loosens* positive
    lower bounds, so tightened-set midpoints can violate the original
    set).  Returns (rows, cols, targets) numpy arrays.
    """
    kinds, rows, cols, p1s, p2s = parse_constset(constset, 1.0)
    entries: dict = {}
    for kind, r, c, p1, p2 in zip(kinds, rows, cols, p1s, p2s):
        e = entries.setdefault(
            (int(r), int(c)), {"lo": -np.inf, "hi": np.inf, "holes": []}
        )
        if kind == KIND_LS:
            e["lo"] = max(e["lo"], float(p1))
        elif kind == KIND_RS:
            e["hi"] = min(e["hi"], float(p2))
        else:
            # |a - cc| >= |k|; k enters the constraint as k^2 and the
            # generator's k = cc + u*(aval - cc) is negative for aval < 0
            half = abs(float(p2))
            e["holes"].append((float(p1) - half, float(p1) + half))
    t_rows, t_cols, t_vals = [], [], []
    for (r, c), e in sorted(entries.items()):
        lo, hi = e["lo"], e["hi"]
        if not np.isfinite(lo):  # guard: entry without a box row
            lo = min([h[0] for h in e["holes"]], default=-1.0) - 1.0
        if not np.isfinite(hi):
            hi = max([h[1] for h in e["holes"]], default=1.0) + 1.0
        segs = [(lo, hi)]
        for a, b in e["holes"]:
            segs = [
                s
                for seg in segs
                for s in ((seg[0], min(seg[1], a)), (max(seg[0], b), seg[1]))
            ]
        segs = [s for s in segs if s[1] > s[0]]
        if not segs:
            raise ValueError(
                f"entry ({r},{c}): tightened feasible set is empty"
            )
        lo_s, hi_s = max(segs, key=lambda s: s[1] - s[0])
        t_rows.append(r)
        t_cols.append(c)
        t_vals.append(0.5 * (lo_s + hi_s))
    return (
        np.asarray(t_rows, np.int32),
        np.asarray(t_cols, np.int32),
        np.asarray(t_vals),
    )


def generate_interior_initialpoint_lsq(
    key,
    d: int,
    constset,
    scaling: float = 1.0,
    interior_scaling: float = 0.95,
    max_tries: int = 10,
    cg_iters: int = 1000,
):
    """Scalable feasible-interior start search (extension; no reference
    equivalent beyond d=5).

    The reference's RALM feasibility search (``generator.py:137-223``)
    relies on a random start landing in the basin of a feasible point; the
    twobox annuli are nonconvex, so that basin vanishes as d (and the
    constraint count ~0.4 d^2) grows — measured: 0/30 successes at d=16.
    Here we instead (1) construct a strictly feasible target value per
    constrained entry of A (``feasible_entry_targets``), and (2) drive
    those entries of A(J,R,Q) = (J-R)Q to their targets by Riemannian
    least-squares with the conjugate-gradient subsolver — smooth,
    overparametrized ((3d^2+d)/2 parameters vs ~0.3 d^2 targets), so the
    residual generically reaches ~0.  Stability is structural: for any
    R, Q > 0, sym(Q^{1/2}(J-R)Q^{1/2}) = -Q^{1/2} R Q^{1/2} < 0, so
    A = (J-R)Q is Hurwitz with no retry loop.
    """
    from riptrm_tpu.solvers.subsolvers import conjugate_gradient

    man = Product(
        [SkewSymmetric(d), SymmetricPositiveDefinite(d), SymmetricPositiveDefinite(d)]
    )
    del interior_scaling  # targets use the original set (see feasible_entry_targets)
    t_rows, t_cols, t_vals = feasible_entry_targets(constset)
    rows_j, cols_j = jnp.asarray(t_rows), jnp.asarray(t_cols)
    targets_j = jnp.asarray(t_vals)
    sqrt_s = math.sqrt(scaling)

    def cost(x):
        J, R, Q = x
        a = ((J - R) @ Q)[rows_j, cols_j]
        return jnp.sum((a - targets_j) ** 2)

    egrad = jax.grad(cost)

    def rgrad(x):
        return man.egrad2rgrad(x, egrad(x))

    key = _cpu_key(key)
    cpu = local_cpu()
    for _ in range(max_tries):
        with jax.default_device(cpu):
            key, sub = jax.random.split(key)
            J, R, Q = man.random_point(sub)
            x0 = (sqrt_s * J, sqrt_s * R, sqrt_s * Q)
            res = conjugate_gradient(
                man, cost, rgrad, x0,
                max_iterations=cg_iters, min_gradient_norm=1e-12,
            )
        Jf, Rf, Qf = (np.asarray(a) for a in res.point)
        A = (Jf - Rf) @ Qf
        orig = make_problem(d, [], constset, (Jf, Rf, Qf), cost_zero=True)
        interior = bool(np.all(np.asarray(orig.ineq_val(orig.x0)) < 0))
        stable = bool(np.all(np.real(np.linalg.eigvals(A)) < 0))
        if interior and stable:
            return Jf, Rf, Qf, A
    raise ValueError("Cannot find a feasible and interior initial point.")


def generate_interior_initialpoint(
    key,
    d: int,
    constset,
    scaling: float = 1.0,
    interior_scaling: float = 0.95,
    ralm_option=None,
    max_tries: int = 10,
):
    """RALM-based feasible-interior initial point search
    (``generator.py:137-223``): random start, solve a feasibility problem
    with tightened constraints, retry until the resulting A is stable and
    strictly interior for the original constraints."""
    from riptrm_tpu.solvers.ralm import RALM

    man = Product([SkewSymmetric(d), SymmetricPositiveDefinite(d), SymmetricPositiveDefinite(d)])
    sqrt_s = math.sqrt(scaling)
    option = {"maxtime": 100, "maxiter": 4, "tolresid": 1e-2, "verbosity": 0}
    option.update(ralm_option or {})

    key = _cpu_key(key)
    cpu = local_cpu()
    for attempt in range(max_tries):
        with jax.default_device(cpu):
            key, sub = jax.random.split(key)
            J, R, Q = man.random_point(sub)
            x_start = (sqrt_s * J, sqrt_s * R, sqrt_s * Q)
            problem = make_problem(
                d, [], constset, x_start, h=0.02,
                interior_scaling=interior_scaling, cost_zero=True,
            )
            out = RALM(option).run(problem)
        Jf, Rf, Qf = (np.asarray(a) for a in out.x)
        A = (Jf - Rf) @ Qf
        stable = np.all(np.real(np.linalg.eigvals(A)) < 0)
        orig = make_problem(d, [], constset, (Jf, Rf, Qf), cost_zero=True)
        interior = bool(np.all(np.asarray(orig.ineq_val(orig.x0)) <= 0))
        if stable and interior:
            return Jf, Rf, Qf, A
    raise ValueError("Cannot find a feasible and interior initial point.")
