"""Compensated (double-word) f32 reductions for the batched-lane floor.

Batched sweeps run the whole solver in f32; the inner-loop stall
floor is set by a handful of SCALAR reductions whose rounding noise is
O(eps * magnitude * sqrt(m)) — chiefly the complementarity norm
``||y*c - mu||`` (each product rounds at eps*|y*c| ~ eps*mu near the
central path, so the norm floors at eps*mu*sqrt(m) even when the true
residual is far smaller) and the ared barrier log-ratio sum (m tiny log
terms accumulated across lanes).  Full f64 widens the elementwise bulk
too; these helpers
widen ONLY the reductions with error-free transformations (TwoSum / Dekker
TwoProd) at a few extra elementwise flops, all branch-free and vmap-friendly (no
sequential Kahan scan — the accumulation is a TwoSum tree with an O(eps^2)
error channel).

No FMA is assumed (jax.lax exposes none): TwoProd uses Dekker's split,
exact in any faithfully-rounded binary arithmetic.

References: Ogita, Rump & Oishi, "Accurate Sum and Dot Product", SIAM
J. Sci. Comput. 26(6), 2005.  No reference-repo counterpart — the
reference runs f64 CPU solves and never faces this floor (its norms are
plain numpy, ``/root/reference/src/solver/RIPTRM.py:574-629``).
"""

from __future__ import annotations

import jax.numpy as jnp


def two_sum(a, b):
    """Knuth TwoSum: (s, e) with s = fl(a+b) and s + e = a + b exactly."""
    s = a + b
    bp = s - a
    e = (a - (s - bp)) + (b - bp)
    return s, e


def _splitter(dtype):
    # 2^ceil(t/2) + 1 with t the significand width: 12 bits for f32 (t=24),
    # 27 for f64 (t=53).
    return jnp.asarray(
        134217729.0 if jnp.finfo(dtype).bits == 64 else 4097.0, dtype
    )


def _split(a):
    """Dekker split: a = hi + lo with both halves half-width exact."""
    c = _splitter(a.dtype) * a
    hi = c - (c - a)
    return hi, a - hi


def two_prod(a, b):
    """Dekker TwoProd: (p, e) with p = fl(a*b) and p + e = a*b exactly."""
    p = a * b
    ah, al = _split(a)
    bh, bl = _split(b)
    e = ((ah * bh - p) + ah * bl + al * bh) + al * bl
    return p, e


def sum2(x, axis=-1):
    """Doubly-compensated sum along ``axis``: a TwoSum reduction tree whose
    per-level errors are themselves accumulated, giving the result as if
    computed at twice the working precision (error O(eps|sum| + eps^2
    sum|x|)).  Fully vectorized — log2(m) unrolled levels, no scan — so it
    vmaps over batch lanes at elementwise speed."""
    x = jnp.moveaxis(x, axis, -1)
    err = jnp.zeros(x.shape[:-1], dtype=x.dtype)
    while x.shape[-1] > 1:
        m = x.shape[-1]
        if m % 2:
            x = jnp.concatenate(
                [x, jnp.zeros(x.shape[:-1] + (1,), dtype=x.dtype)], axis=-1
            )
        s, e = two_sum(x[..., ::2], x[..., 1::2])
        # level errors are O(eps * partials): a plain sum of them only
        # contributes at O(eps^2)
        err = err + jnp.sum(e, axis=-1)
        x = s
    return x[..., 0] + err


def dot2(a, b, axis=-1):
    """Compensated dot product (Ogita-Rump-Oishi Dot2): result as if
    computed in twice the working precision."""
    p, e = two_prod(a, b)
    return sum2(p, axis=axis) + jnp.sum(e, axis=axis)


def complementarity_norm(y, c, mu):
    """Compensated ``||y*c - mu||_2`` — the inner-loop complementarity
    criterion (reference ``RIPTRM.py:574-629``; naive form at
    ``solvers/riptrm.py``).

    TwoProd recovers each product's rounding exactly and TwoSum performs
    the cancellation against mu error-free, so the per-element residual is
    accurate to eps*|residual| instead of eps*mu; the squared sum then runs
    through the compensated tree.  The eps*mu*sqrt(m) reduction floor
    drops to the noise already present in y and c themselves.
    """
    p, e = two_prod(y, c)
    d, de = two_sum(p, -mu)
    r = d + (e + de)  # exact cancellation + restored product rounding
    return jnp.sqrt(jnp.maximum(dot2(r, r), 0.0))


def barrier_log_ratio_sum(c_new, c, mu):
    """Compensated ``mu * sum_i log(c_new_i / c_i)`` — the ared barrier
    term (difference form, see solvers/riptrm.py ared notes).

    For accepted steps most slacks move a tiny relative amount; there
    ``log(fl(c_new/c))`` carries an eps absolute error per term (the
    division rounds at eps while the true log is ~0), so m terms floor the
    sum at eps*sqrt(m).  ``log1p((c_new - c)/c)`` is conditioned on the
    difference instead — exact where Sterbenz applies (ratio in [1/2, 2])
    — and the m-term accumulation runs through the compensated tree.
    Non-positive slack pairs contribute 0, matching the naive path's
    ``ratio = 1`` masking.
    """
    ok = (c_new > 0) & (c > 0)
    safe_c = jnp.where(ok, c, 1.0)
    safe_cn = jnp.where(ok, c_new, 1.0)
    t = (safe_cn - safe_c) / safe_c
    near = t > -0.5  # ratio > 1/2: log1p form is the conditioned one
    terms = jnp.where(
        near,
        jnp.log1p(jnp.where(near, t, 0.0)),
        jnp.log(jnp.where(near, 1.0, safe_cn / safe_c)),
    )
    return mu * sum2(terms)
