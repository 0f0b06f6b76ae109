"""Log-semiring primitives for the banded DP kernels.

All DP values are log-space; zero = -inf, one = 0 (util.hpp:192-229).
Every reduction here is written so that reverse-mode autodiff is NaN-free
around -inf masks: the backward pass of the DP (ops/dp.py) is jax.vjp
through these ops, so d(LSE)/dx must be exactly 0 for -inf terms and for
all-empty reductions.
"""
from __future__ import annotations

import jax
import jax.numpy as jnp

NEG = -jnp.inf


def lse(x, axis=-1):
    """logsumexp with autodiff-safe -inf handling."""
    m = jax.lax.stop_gradient(jnp.max(x, axis=axis, keepdims=True))
    m0 = jnp.where(jnp.isfinite(m), m, 0.0)
    s = jnp.sum(jnp.exp(x - m0), axis=axis)
    m0r = jnp.squeeze(m0, axis=axis)
    tiny = jnp.finfo(x.dtype).tiny
    return jnp.where(s > 0, m0r + jnp.log(jnp.maximum(s, tiny)), NEG)


def logadd(a, b):
    """Elementwise log(e^a + e^b), -inf-safe in forward and backward."""
    m = jax.lax.stop_gradient(jnp.maximum(a, b))
    m0 = jnp.where(jnp.isfinite(m), m, 0.0)
    s = jnp.exp(a - m0) + jnp.exp(b - m0)
    tiny = jnp.finfo(s.dtype).tiny
    return jnp.where(s > 0, m0 + jnp.log(jnp.maximum(s, tiny)), NEG)


def logmm(v, m):
    """out[..., s] = LSE_{s1}( v[..., s1] + m[s, s1] )."""
    return lse(v[..., None, :] + m, axis=-1)


def lam_mul(lam, tsc):
    """lambda * tsc with the reference's skip-on-zero semantics: -inf
    energies stay -inf even for lambda == 0 (energy_model.hpp guards
    `zeroL != tsc` before applying `lam*tsc`).  d/dlam is tsc where
    finite, 0 otherwise — exactly the reference's EH statistic."""
    return jnp.where(jnp.isneginf(tsc), NEG, lam * jnp.where(
        jnp.isneginf(tsc), 0.0, tsc))


def mask_neg(x, mask):
    """Gate log values: keep where mask else -inf (NaN-safe)."""
    return jnp.where(mask, x, NEG)


def shear(A, J: int, fill=NEG):
    """Skew read Y[d, j] = A[d, j - d] without a gather.

    A: [D, R, ...tail] -> Y: [D, J, ...tail]; out-of-range (j < d or
    j - d >= R) filled with `fill`.  Implemented as pad + leading-dims
    reshape + slice, i.e. plain copies, instead of take_along_axis,
    which lowers to a gather.
    """
    D, R = A.shape[0], A.shape[1]
    tail = A.shape[2:]
    K = R + max(D, J - R + 1)
    M2 = jnp.pad(A, ((0, 0), (0, K - R)) + ((0, 0),) * len(tail),
                 constant_values=fill)
    flat = M2.reshape((D * K,) + tail)
    Y = flat[: D * (K - 1)].reshape((D, K - 1) + tail)
    return Y[:, :J]


def seg_lse(values, segments, num_segments):
    """Segment-wise logsumexp along the leading axis of `values`.

    values: [n, ...]; segments: [n] int; -> [num_segments, ...].
    Autodiff-safe like lse().
    """
    mx = jax.lax.stop_gradient(
        jax.ops.segment_max(values, segments, num_segments=num_segments))
    mx_safe = jnp.where(jnp.isfinite(mx), mx, 0.0)
    ex = jnp.exp(values - mx_safe[segments])
    sm = jax.ops.segment_sum(ex, segments, num_segments=num_segments)
    tiny = jnp.finfo(values.dtype).tiny
    return jnp.where(sm > 0, mx_safe + jnp.log(jnp.maximum(sm, tiny)), NEG)
