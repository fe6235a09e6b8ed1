"""Conditional distribution primitives: diagonal/full MVN, Poisson, Dirac delta.

Covers the reference's `distribution/` package (`base.py`, `mvn.py`,
`poisson.py`, `dirac_delta.py` — SURVEY.md §2-A, paths unverified): each
reference distribution wraps a transformation into a conditional distribution
exposing `sample` / `log_prob`. Here the equivalent is a set of *pure
functions* over explicit `(mean, scale)` tensors so that everything traces
into one XLA program — the "distribution object" of the reference dissolves
into the SSM heads (`psvo_tpu.models.ssm`), which produce the parameters, plus
these kernels, which consume them.

All functions broadcast over arbitrary leading axes (batch, particle, time)
and keep the event axis last. Computation is float32: log-densities need the
mantissa; the MLP matmuls that *produce* the parameters are where bf16
throughput lives (`TrainConfig.bf16_matmuls`).
"""

from __future__ import annotations

import math

import jax
import jax.numpy as jnp

_HALF_LOG_2PI = 0.5 * math.log(2.0 * math.pi)


# ---------------------------------------------------------------------------
# Diagonal multivariate normal (the workhorse — reference `distribution/mvn.py`)
# ---------------------------------------------------------------------------


def mvn_diag_sample(key: jax.Array, mean: jax.Array, scale: jax.Array) -> jax.Array:
    """Reparameterized sample: mean + scale * eps, eps ~ N(0, I).

    `scale` is the per-dimension standard deviation (already floored by the
    head that produced it — see `networks.scale_from_raw`). Broadcasts:
    `mean`/`scale` may have any matching leading shape.
    """
    eps = jax.random.normal(key, jnp.broadcast_shapes(mean.shape, scale.shape), mean.dtype)
    return mean + scale * eps


# Finiteness guard: a diverging network mean (f32 activation overflow turns
# it inf) makes every particle's log-weight -inf and the whole objective NaN
# *persistently* — observed on Lorenz-63 after ~1k steps. Flooring the
# REDUCED log-density keeps it a finite, astronomically-negative number (the
# offending particle simply never wins, its gradient is cut, training can
# recover). The floor is applied after the event-axis reduction on purpose:
# clipping z per-element instead broke XLA's fusion of the density chain.
_MIN_LOGP = -1e30


def mvn_diag_log_prob(x: jax.Array, mean: jax.Array, scale: jax.Array) -> jax.Array:
    """Log density of a diagonal-covariance Gaussian, reduced over the last axis."""
    z = (x - mean) / scale
    logp = jnp.sum(-0.5 * z * z - jnp.log(scale) - _HALF_LOG_2PI, axis=-1)
    return jnp.maximum(logp, _MIN_LOGP)


def mvn_diag_log_prob_cm(x: jax.Array, mean: jax.Array, scale: jax.Array) -> jax.Array:
    """`mvn_diag_log_prob` in channel-major layout: event axis at -2.

    The forward filter stores particles as [B, D, K] so the wide K axis is
    the minor axis and the tiny D is reduced across rows.
    """
    z = (x - mean) / scale
    logp = jnp.sum(-0.5 * z * z - jnp.log(scale) - _HALF_LOG_2PI, axis=-2)
    return jnp.maximum(logp, _MIN_LOGP)


def mvn_product(
    mean_a: jax.Array,
    scale_a: jax.Array,
    mean_b: jax.Array,
    scale_b: jax.Array,
) -> tuple[jax.Array, jax.Array]:
    """Precision-weighted product of two diagonal Gaussians (the `use_2_q` fusion).

    The reference fuses its dynamics proposal q1(x_t | x_{t-1}) with its
    encoder proposal q2(x_t | y_t) into a single Gaussian (SURVEY.md §3.2);
    closed form: Lambda = 1/s_a^2 + 1/s_b^2, var = 1/Lambda,
    mean = var * (m_a/s_a^2 + m_b/s_b^2). Unit-tested against the closed form
    and a quadrature oracle in tests/test_distributions.py.
    """
    prec_a = 1.0 / (scale_a * scale_a)
    prec_b = 1.0 / (scale_b * scale_b)
    var = 1.0 / (prec_a + prec_b)
    mean = var * (mean_a * prec_a + mean_b * prec_b)
    return mean, jnp.sqrt(var)


# ---------------------------------------------------------------------------
# Full-covariance multivariate normal (parameterized by Cholesky factor)
# ---------------------------------------------------------------------------


def mvn_full_sample(key: jax.Array, mean: jax.Array, chol: jax.Array) -> jax.Array:
    """Sample x = mean + L @ eps with L lower-triangular Cholesky of the covariance."""
    eps = jax.random.normal(key, mean.shape, mean.dtype)
    return mean + jnp.einsum("...ij,...j->...i", chol, eps)


def mvn_full_log_prob(x: jax.Array, mean: jax.Array, chol: jax.Array) -> jax.Array:
    """Log density with covariance L L^T; solves the triangular system directly."""
    d = x.shape[-1]
    diff = x - mean
    batch_shape = jnp.broadcast_shapes(diff.shape[:-1], chol.shape[:-2])
    chol_b = jnp.broadcast_to(chol, (*batch_shape, d, d))
    diff_b = jnp.broadcast_to(diff, (*batch_shape, d))
    z = jax.scipy.linalg.solve_triangular(chol_b, diff_b[..., None], lower=True)[..., 0]
    log_det = jnp.sum(jnp.log(jnp.diagonal(chol_b, axis1=-2, axis2=-1)), axis=-1)
    logp = -0.5 * jnp.sum(z * z, axis=-1) - log_det - d * _HALF_LOG_2PI
    return jnp.maximum(logp, _MIN_LOGP)


def mvn_full_log_prob_cm(x: jax.Array, mean: jax.Array, chol: jax.Array) -> jax.Array:
    """Full-covariance Gaussian log density in channel-major layout.

    x/mean [..., D, K] with a CONSTANT [D, D] Cholesky factor (the
    cov_type="tril" heads are state-independent): one triangular solve
    against the [D, K] matrix per batch row.
    """
    d = chol.shape[-1]
    diff = x - mean
    chol_b = jnp.broadcast_to(chol, (*diff.shape[:-2], d, d))
    z = jax.scipy.linalg.solve_triangular(chol_b, diff, lower=True)
    log_det = jnp.sum(jnp.log(jnp.diagonal(chol)))
    logp = -0.5 * jnp.sum(z * z, axis=-2) - log_det - d * _HALF_LOG_2PI
    return jnp.maximum(logp, _MIN_LOGP)


def mvn_tril_log_prob_cm(
    x: jax.Array, mean: jax.Array, diag: jax.Array, off: jax.Array
) -> jax.Array:
    """Full-covariance Gaussian log density with a PER-PARTICLE packed
    Cholesky factor, channel-major (cov_type="tril_head").

    x/mean/diag [..., D, K]; off [..., D(D-1)/2, K] row-major strict-lower
    entries (jnp.tril_indices(k=-1) order). The forward substitution
    L z = (x - mean) unrolls over the tiny latent dim (D(D-1)/2 fused
    multiply-adds on [..., K] rows) — a [..., D, D, K] chol tensor or a
    per-particle solve_triangular would materialize/batch K tiny systems.
    """
    d = x.shape[-2]
    diff = x - mean
    zs = []
    p = 0
    for i in range(d):
        acc = diff[..., i, :]
        for j in range(i):
            acc = acc - off[..., p, :] * zs[j]
            p += 1
        zs.append(acc / diag[..., i, :])
    maha = sum(z * z for z in zs)
    log_det = jnp.sum(jnp.log(diag), axis=-2)
    logp = -0.5 * maha - log_det - d * _HALF_LOG_2PI
    return jnp.maximum(logp, _MIN_LOGP)


def mvn_tril_sample_cm(
    eps: jax.Array, mean: jax.Array, diag: jax.Array, off: jax.Array
) -> jax.Array:
    """Reparameterized draw x = mean + L eps with the packed per-particle
    Cholesky factor (channel-major): unrolled x_i = mean_i + diag_i eps_i +
    Σ_{j<i} off_ij eps_j."""
    d = mean.shape[-2]
    rows = []
    p = 0
    for i in range(d):
        acc = diag[..., i, :] * eps[..., i, :]
        for j in range(i):
            acc = acc + off[..., p, :] * eps[..., j, :]
            p += 1
        rows.append(mean[..., i, :] + acc)
    return jnp.stack(rows, axis=-2)


# ---------------------------------------------------------------------------
# Poisson (count emissions — reference `distribution/poisson.py`)
# ---------------------------------------------------------------------------


def poisson_log_prob(y: jax.Array, log_rate: jax.Array) -> jax.Array:
    """sum_d [ y_d * log_rate_d - rate_d - lgamma(y_d + 1) ] over the event axis.

    log_rate is clamped to ±80 (exp(88) overflows f32): a diverging rate head
    yields a huge-but-finite penalty instead of inf-contaminated weights.
    """
    log_rate = jnp.clip(log_rate, -80.0, 80.0)
    rate = jnp.exp(log_rate)
    return jnp.sum(y * log_rate - rate - jax.lax.lgamma(y + 1.0), axis=-1)


def poisson_log_prob_cm(y: jax.Array, log_rate: jax.Array) -> jax.Array:
    """`poisson_log_prob` with the event axis at -2 (channel-major layout)."""
    log_rate = jnp.clip(log_rate, -80.0, 80.0)
    rate = jnp.exp(log_rate)
    return jnp.sum(y * log_rate - rate - jax.lax.lgamma(y + 1.0), axis=-2)


def poisson_sample(key: jax.Array, log_rate: jax.Array) -> jax.Array:
    """Poisson draw (data generation only; not reparameterizable)."""
    return jax.random.poisson(key, jnp.exp(log_rate)).astype(jnp.float32)


# ---------------------------------------------------------------------------
# Dirac delta (deterministic maps — reference `distribution/dirac_delta.py`)
# ---------------------------------------------------------------------------


def dirac_sample(key: jax.Array, mean: jax.Array) -> jax.Array:  # noqa: ARG001
    """A Dirac delta "draw" is just its location."""
    return mean


def dirac_log_prob(x: jax.Array, mean: jax.Array) -> jax.Array:  # noqa: ARG001
    """Reference semantics: contributes 0 to log-weights (constant density)."""
    return jnp.zeros(x.shape[:-1], x.dtype)


# ---------------------------------------------------------------------------
# Shared numerics helpers
# ---------------------------------------------------------------------------


def log_normalize(logw: jax.Array, axis: int = -1) -> tuple[jax.Array, jax.Array]:
    """Return (normalized log-weights, logsumexp) along `axis`, max-shifted."""
    m = jax.lax.stop_gradient(jnp.max(logw, axis=axis, keepdims=True))
    shifted = logw - m
    lse = jnp.log(jnp.sum(jnp.exp(shifted), axis=axis, keepdims=True)) + m
    return logw - lse, jnp.squeeze(lse, axis=axis)


def effective_sample_size(logw: jax.Array, axis: int = -1) -> jax.Array:
    """ESS = 1 / sum_k W_k^2 of the normalized weights (resampling diagnostic)."""
    logw_norm, _ = log_normalize(logw, axis=axis)
    return jnp.exp(-jax.scipy.special.logsumexp(2.0 * logw_norm, axis=axis))
