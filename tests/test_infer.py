"""Posterior-inference API: shapes + LGSSM oracle sanity."""

import dataclasses

import jax
import numpy as np
import pytest

from psvo_tpu.infer import filter_posterior, smooth_posterior
from tests import helpers
from tests.reference_numpy import rts_smoother


def test_infer_api_matches_rts_on_lgssm():
    p = helpers.default_lgssm()
    rng = np.random.default_rng(3)
    t = 15
    xs, ys = helpers.simulate_lgssm(rng, t_steps=t, batch=3, **p)
    cfg, ssm, params = helpers.lgssm_setup(
        objective="psvo", n_particles=1024, n_smoothing=64, t_steps=t, **p
    )

    means = filter_posterior(ssm, params, ys, cfg)
    assert means.shape == (3, t, 2)

    sm = smooth_posterior(ssm, params, ys, cfg, n_samples=64)
    assert sm.shape == (3, 64, t, 2)

    q = p["q_scale"] ** 2 * np.eye(2)
    r = p["r_scale"] ** 2 * np.eye(2)
    s0 = p["s0_scale"] ** 2 * np.eye(2)
    rts = np.stack(
        [rts_smoother(ys[b], p["a"], p["c"], q, r, p["mu0"], s0)[0] for b in range(3)]
    )
    rmse = np.sqrt(np.mean((np.asarray(sm.mean(axis=1)) - rts) ** 2))
    assert rmse < 0.15, rmse


def test_infer_with_particles():
    p = helpers.default_lgssm()
    rng = np.random.default_rng(4)
    _, ys = helpers.simulate_lgssm(rng, t_steps=8, batch=2, **p)
    cfg, ssm, params = helpers.lgssm_setup(
        objective="fivo", n_particles=64, t_steps=8, **p
    )
    means, particles, logws = filter_posterior(
        ssm, params, ys, cfg, return_particles=True
    )
    assert particles.shape == (2, 8, 64, 2)
    assert logws.shape == (2, 8, 64)
    # weighted particle mean must reproduce the emitted filtering means
    w = np.exp(np.asarray(logws) - np.max(np.asarray(logws), axis=-1, keepdims=True))
    w = w / w.sum(-1, keepdims=True)
    manual = np.einsum("btk,btkd->btd", w, np.asarray(particles))
    np.testing.assert_allclose(np.asarray(means), manual, rtol=1e-4, atol=1e-5)


def test_infer_controls_required_and_used():
    """A di>0 model must (a) refuse inference without its controls and
    (b) actually condition the posterior on them: silently-zero controls
    would give wrong posteriors with no error."""
    from psvo_tpu.config import preset
    from psvo_tpu.models.ssm import init_ssm

    cfg = preset("fhn_fivo_controls")
    cfg = dataclasses.replace(
        cfg,
        data=dataclasses.replace(cfg.data, t_steps=8),
        smc=dataclasses.replace(cfg.smc, n_particles=32),
    )
    ssm, params = init_ssm(cfg, jax.random.key(0))
    rng = np.random.default_rng(0)
    ys = rng.standard_normal((2, 8, cfg.data.dy)).astype(np.float32)
    u = rng.standard_normal((2, 8, cfg.data.di)).astype(np.float32)

    with pytest.raises(ValueError, match="control"):
        filter_posterior(ssm, params, ys, cfg)
    with pytest.raises(ValueError, match="control"):
        smooth_posterior(ssm, params, ys, cfg)

    m_u = filter_posterior(ssm, params, ys, cfg, controls=u)
    m_0 = filter_posterior(ssm, params, ys, cfg, controls=np.zeros_like(u))
    assert m_u.shape == (2, 8, cfg.data.dx)
    assert not np.allclose(np.asarray(m_u), np.asarray(m_0)), (
        "controls did not change the filtering posterior"
    )
    sm = smooth_posterior(ssm, params, ys, cfg, n_samples=4, controls=u)
    assert sm.shape == (2, 4, 8, cfg.data.dx)

    # a di=0 model must reject spurious controls
    p0 = helpers.default_lgssm()
    cfg0, ssm0, params0 = helpers.lgssm_setup(t_steps=8, n_particles=16, **p0)
    _, ys0 = helpers.simulate_lgssm(
        np.random.default_rng(1), t_steps=8, batch=2, **p0
    )
    with pytest.raises(ValueError, match="di=0"):
        filter_posterior(ssm0, params0, ys0, cfg0, controls=np.zeros((2, 8, 1)))
