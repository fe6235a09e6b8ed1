"""Unit tests: multinomial/systematic resampling vs NumPy oracle + statistics."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest

pytestmark = pytest.mark.fast  # <2 min verification subset

from psvo_tpu.ops import resampling


def _numpy_inverse_cdf(cumw, u):
    out = np.zeros_like(u, dtype=np.int64)
    for b in range(u.shape[0]):
        out[b] = np.searchsorted(cumw[b], u[b], side="right")
    return np.minimum(out, cumw.shape[-1] - 1)


def test_inverse_cdf_indices_vs_numpy_oracle():
    rng = np.random.default_rng(0)
    w = rng.dirichlet(np.ones(33), size=5).astype(np.float32)
    cumw = np.cumsum(w, axis=-1)
    u = np.sort(rng.uniform(size=(5, 33)), axis=-1).astype(np.float32)
    got = resampling.inverse_cdf_indices(jnp.asarray(cumw), jnp.asarray(u))
    np.testing.assert_array_equal(np.asarray(got), _numpy_inverse_cdf(cumw, u))


def test_systematic_offspring_within_one_of_expectation():
    """Systematic resampling guarantees |count_i - K*W_i| < 1 deterministically."""
    rng = np.random.default_rng(1)
    k = 256
    logw = jnp.asarray(rng.standard_normal((3, k)).astype(np.float32) * 2)
    idx = resampling.resample_indices(jax.random.key(0), logw, "systematic")
    w = np.exp(np.asarray(logw) - np.asarray(jax.scipy.special.logsumexp(logw, -1))[:, None])
    for b in range(3):
        counts = np.bincount(np.asarray(idx[b]), minlength=k)
        assert np.all(np.abs(counts - k * w[b]) < 1.0 + 1e-4)


def test_multinomial_frequencies_match_weights():
    rng = np.random.default_rng(2)
    k = 64
    w = rng.dirichlet(np.ones(k)).astype(np.float32)
    logw = jnp.log(jnp.asarray(w))[None].repeat(200, axis=0)  # 200 independent rows
    idx = resampling.resample_indices(jax.random.key(3), logw, "multinomial")
    counts = np.bincount(np.asarray(idx).ravel(), minlength=k)
    freq = counts / counts.sum()
    # ~12.8k draws; loose 5-sigma-ish bound per bin
    se = np.sqrt(w * (1 - w) / counts.sum())
    assert np.all(np.abs(freq - w) < 5 * se + 1e-3)


def test_systematic_histogram_matches_searchsorted():
    """The O(K) histogram formulation must agree with the search oracle."""
    rng = np.random.default_rng(7)
    for k in (64, 1024):
        logw = jnp.asarray(rng.standard_normal((6, k)).astype(np.float32) * 2)
        u0 = jnp.asarray(rng.uniform(size=(6,)).astype(np.float32))
        logw_norm = logw - jax.scipy.special.logsumexp(logw, -1, keepdims=True)
        cumw = jnp.cumsum(jnp.exp(logw_norm), axis=-1)
        u = resampling.quantile_positions_from_raw(u0, k, "systematic")
        want = np.asarray(resampling.inverse_cdf_indices(cumw, u))
        got = np.asarray(resampling.systematic_indices_histogram(cumw, u0))
        diff = np.abs(got.astype(np.int64) - want.astype(np.int64))
        # float boundary ties can flip an index by ±1; anything more is a bug
        assert diff.max() <= 1 and np.mean(diff == 0) > 0.995, (k, diff.max())


def test_indices_are_sorted_for_sorted_positions():
    """Inverse-CDF of sorted positions is monotone (ancestors come out sorted)."""
    rng = np.random.default_rng(3)
    logw = jnp.asarray(rng.standard_normal((4, 128)).astype(np.float32))
    for method in ("systematic", "multinomial"):
        idx = np.asarray(resampling.resample_indices(jax.random.key(4), logw, method))
        assert np.all(np.diff(idx, axis=-1) >= 0), method


def test_maybe_resample_threshold_behavior():
    rng = np.random.default_rng(4)
    b, k, d = 2, 32, 3
    # channel-major particles [B, D, K]
    x = jnp.asarray(rng.standard_normal((b, d, k)).astype(np.float32))
    # row 0: uniform weights (ESS = K); row 1: degenerate (ESS ~ 1)
    logw = jnp.stack([jnp.zeros(k), jnp.where(jnp.arange(k) == 5, 0.0, -100.0)])

    u_raw = jax.random.uniform(jax.random.key(0), (b,))
    u = resampling.quantile_positions_from_raw(u_raw, k, "systematic")
    x_out, logw_out, did, ess, _ = resampling.maybe_resample(
        u, logw, x, method="systematic", ess_threshold=0.5
    )
    assert not bool(did[0]) and bool(did[1])
    np.testing.assert_allclose(np.asarray(x_out[0]), np.asarray(x[0]))  # untouched
    np.testing.assert_allclose(np.asarray(logw_out[1]), 0.0)  # reset
    # degenerate row: every resampled particle equals particle 5
    np.testing.assert_allclose(
        np.asarray(x_out[1]),
        np.broadcast_to(np.asarray(x[1, :, 5:6]), (d, k)),
        rtol=1e-6,
    )
    np.testing.assert_allclose(np.asarray(ess[0]), k, rtol=1e-4)


def test_gather_particles():
    # [B, D, K] = [2, 3, 4]: gather along the last (particle) axis
    x = jnp.arange(24, dtype=jnp.float32).reshape(2, 3, 4)
    idx = jnp.array([[3, 3, 0, 1], [0, 0, 0, 2]])
    out = resampling.gather_particles(x, idx)
    np.testing.assert_allclose(np.asarray(out[0, :, 0]), np.asarray(x[0, :, 3]))
    np.testing.assert_allclose(np.asarray(out[1, :, 3]), np.asarray(x[1, :, 2]))
