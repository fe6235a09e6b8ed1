"""Unit tests: distribution log-probs vs scipy, Gaussian-product fusion."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest

pytestmark = pytest.mark.fast  # <2 min verification subset
import scipy.stats

from psvo_tpu import distributions as dist


@pytest.fixture
def rng():
    return np.random.default_rng(0)


def test_mvn_diag_log_prob_matches_scipy(rng):
    x = rng.standard_normal((5, 3)).astype(np.float32)
    mean = rng.standard_normal((5, 3)).astype(np.float32)
    scale = rng.uniform(0.5, 2.0, (5, 3)).astype(np.float32)
    got = dist.mvn_diag_log_prob(jnp.asarray(x), jnp.asarray(mean), jnp.asarray(scale))
    want = [
        scipy.stats.multivariate_normal(mean[i], np.diag(scale[i] ** 2)).logpdf(x[i])
        for i in range(5)
    ]
    np.testing.assert_allclose(np.asarray(got), want, rtol=1e-5)


def test_mvn_full_log_prob_matches_scipy(rng):
    d = 4
    a = rng.standard_normal((d, d))
    cov = a @ a.T + d * np.eye(d)
    chol = np.linalg.cholesky(cov).astype(np.float32)
    x = rng.standard_normal((7, d)).astype(np.float32)
    mean = rng.standard_normal((d,)).astype(np.float32)
    got = dist.mvn_full_log_prob(
        jnp.asarray(x), jnp.asarray(mean), jnp.asarray(chol)
    )
    want = scipy.stats.multivariate_normal(mean, cov).logpdf(x)
    np.testing.assert_allclose(np.asarray(got), want, rtol=1e-4)


def test_poisson_log_prob_matches_scipy(rng):
    y = rng.poisson(3.0, (6, 2)).astype(np.float32)
    log_rate = rng.uniform(-1, 2, (6, 2)).astype(np.float32)
    got = dist.poisson_log_prob(jnp.asarray(y), jnp.asarray(log_rate))
    want = scipy.stats.poisson(np.exp(log_rate)).logpmf(y).sum(-1)
    np.testing.assert_allclose(np.asarray(got), want, rtol=1e-5)


def test_mvn_product_closed_form(rng):
    """Product density must equal the pointwise product up to normalization."""
    m1, s1 = jnp.array([0.5]), jnp.array([1.2])
    m2, s2 = jnp.array([-0.3]), jnp.array([0.7])
    mp, sp = dist.mvn_product(m1, s1, m2, s2)
    xs = jnp.linspace(-4, 4, 201)[:, None]
    log_prod = dist.mvn_diag_log_prob(xs, m1, s1) + dist.mvn_diag_log_prob(xs, m2, s2)
    log_fused = dist.mvn_diag_log_prob(xs, mp, sp)
    # difference must be a constant (the normalizer) across x
    diff = np.asarray(log_prod - log_fused)
    np.testing.assert_allclose(diff, diff[0], atol=1e-4)


def test_mvn_product_precision_formula(rng):
    m1 = rng.standard_normal((4, 3)).astype(np.float32)
    m2 = rng.standard_normal((4, 3)).astype(np.float32)
    s1 = rng.uniform(0.3, 2.0, (4, 3)).astype(np.float32)
    s2 = rng.uniform(0.3, 2.0, (4, 3)).astype(np.float32)
    mp, sp = dist.mvn_product(*map(jnp.asarray, (m1, s1, m2, s2)))
    prec = 1 / s1**2 + 1 / s2**2
    np.testing.assert_allclose(np.asarray(sp), np.sqrt(1 / prec), rtol=1e-5)
    np.testing.assert_allclose(
        np.asarray(mp), (m1 / s1**2 + m2 / s2**2) / prec, rtol=1e-4, atol=1e-5
    )


def test_mvn_diag_sample_moments():
    key = jax.random.key(0)
    mean = jnp.array([1.0, -2.0])
    scale = jnp.array([0.5, 2.0])
    x = dist.mvn_diag_sample(key, jnp.broadcast_to(mean, (20000, 2)), scale)
    np.testing.assert_allclose(np.asarray(x.mean(0)), mean, atol=0.05)
    np.testing.assert_allclose(np.asarray(x.std(0)), scale, rtol=0.05)


def test_log_normalize_and_ess():
    logw = jnp.log(jnp.array([[0.1, 0.2, 0.3, 0.4]])) + 7.3  # arbitrary shift
    logw_norm, lse = dist.log_normalize(logw, axis=-1)
    np.testing.assert_allclose(np.exp(np.asarray(logw_norm)).sum(-1), 1.0, rtol=1e-6)
    np.testing.assert_allclose(np.asarray(lse), np.log(1.0) + 7.3, rtol=1e-6)
    ess = dist.effective_sample_size(logw)
    want = 1.0 / np.sum(np.array([0.1, 0.2, 0.3, 0.4]) ** 2)
    np.testing.assert_allclose(np.asarray(ess), want, rtol=1e-5)

    uniform = jnp.zeros((1, 64))
    np.testing.assert_allclose(
        np.asarray(dist.effective_sample_size(uniform)), 64.0, rtol=1e-5
    )
