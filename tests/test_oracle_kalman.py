"""Golden-value oracle tests (SURVEY.md §4.2): on a linear-Gaussian SSM the
SMC objectives must converge to the exact Kalman log-likelihood, and FFBSi
smoothed means must match the RTS smoother. This replaces 'numerics match the
reference TF implementation' — the reference source is unreadable (SURVEY.md
§0) — with an *exact* oracle."""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest

_FAST = pytest.mark.fast  # <2 min verification subset

from psvo_tpu.objectives import make_objective
from tests import helpers
from tests.reference_numpy import kalman_filter, rts_smoother
from tests.reference_numpy.numpy_smc import NumpySSMParams, numpy_forward_filter

BATCH = 4
T = 20


@pytest.fixture(scope="module")
def lgssm():
    p = helpers.default_lgssm()
    rng = np.random.default_rng(42)
    xs, ys = helpers.simulate_lgssm(rng, t_steps=T, batch=BATCH, **p)
    q = p["q_scale"] ** 2 * np.eye(2)
    r = p["r_scale"] ** 2 * np.eye(2)
    s0 = p["s0_scale"] ** 2 * np.eye(2)
    kf_loglik = np.array(
        [kalman_filter(ys[b], p["a"], p["c"], q, r, p["mu0"], s0)[0] for b in range(BATCH)]
    )
    rts_means = np.stack(
        [rts_smoother(ys[b], p["a"], p["c"], q, r, p["mu0"], s0)[0] for b in range(BATCH)]
    )  # [B, T, Dx]
    return dict(p=p, xs=xs, ys=ys, kf_loglik=kf_loglik, rts_means=rts_means)


def _run(lgssm, objective, k, resampling="systematic", m=16, seed=0):
    cfg, ssm, params = helpers.lgssm_setup(
        objective=objective,
        n_particles=k,
        n_smoothing=m,
        resampling=resampling,
        t_steps=T,
        **lgssm["p"],
    )
    obj = make_objective(ssm, cfg)
    return jax.jit(obj)(params, jax.random.key(seed), jnp.asarray(lgssm["ys"]))


@_FAST
def test_fivo_logz_matches_kalman(lgssm):
    """Bootstrap FIVO with K=4096 must sit within a fraction of a nat of KF."""
    outs = [np.asarray(_run(lgssm, "fivo", 4096, seed=s).elbo) for s in range(4)]
    logz = np.mean(outs, axis=0)  # [B]
    err = logz - lgssm["kf_loglik"]
    assert np.all(np.abs(err) < 0.35), err
    # log E[Ẑ] = log Z exactly; E[log Ẑ] ≤ log Z (Jensen) — check no upward bias
    assert np.mean(err) < 0.1


@_FAST
def test_iwae_logz_matches_kalman_short_horizon(lgssm):
    """IWAE (no resampling) degenerates in T, so test a short prefix."""
    t_short = 8
    cfg, ssm, params = helpers.lgssm_setup(
        objective="iwae", n_particles=8192, resampling="none", t_steps=t_short,
        **lgssm["p"],
    )
    p = lgssm["p"]
    q = p["q_scale"] ** 2 * np.eye(2)
    r = p["r_scale"] ** 2 * np.eye(2)
    s0 = p["s0_scale"] ** 2 * np.eye(2)
    kf = np.array(
        [
            kalman_filter(lgssm["ys"][b, :t_short], p["a"], p["c"], q, r, p["mu0"], s0)[0]
            for b in range(BATCH)
        ]
    )
    obj = make_objective(ssm, cfg)
    outs = [
        np.asarray(jax.jit(obj)(params, jax.random.key(s), jnp.asarray(lgssm["ys"][:, :t_short])).elbo)
        for s in range(8)
    ]
    err = np.mean(outs, axis=0) - kf
    # IWAE is downward-biased at finite K (Jensen); bound the gap, forbid upside
    assert np.all(err < 0.25), err
    assert np.all(err > -0.8), err


def test_multinomial_resampling_also_unbiased(lgssm):
    outs = [
        np.asarray(_run(lgssm, "fivo", 4096, resampling="multinomial", seed=s).elbo)
        for s in range(4)
    ]
    err = np.mean(outs, axis=0) - lgssm["kf_loglik"]
    assert np.all(np.abs(err) < 0.5), err


def test_psvo_elbo_equals_forward_bound_and_matches_kalman(lgssm):
    out = _run(lgssm, "psvo", 2048, m=32)
    np.testing.assert_allclose(
        float(np.asarray(out.elbo).mean()), float(out.metrics["log_z_fwd"]), rtol=1e-6
    )
    err = np.asarray(out.elbo) - lgssm["kf_loglik"]
    assert np.all(np.abs(err) < 0.6), err


@_FAST
def test_ffbsi_smoothed_means_match_rts(lgssm):
    """PSVO's FFBSi trajectories average to the RTS smoothed means."""
    outs = [_run(lgssm, "psvo", 2048, m=64, seed=s).smoothed for s in range(3)]
    sm = np.mean([np.asarray(o) for o in outs], axis=(0, 3))  # avg seeds & M: [T,B,Dx]
    sm = np.swapaxes(sm, 0, 1)  # [B, T, Dx]
    rmse = np.sqrt(np.mean((sm - lgssm["rts_means"]) ** 2))
    # MC error with 3*64 paths on K=2048 support; RTS scale here is O(1)
    assert rmse < 0.12, rmse


def test_segmented_psvo_matches_kalman_and_rts(lgssm):
    """Long-T path: segmented FFBSi (boundary carries + in-backward segment
    recompute) must hit the same oracles as the full-cache version. T-1=19
    isn't divisible, so run on a T=21 prefix wouldn't match the fixture —
    regenerate a T=25 dataset (24 = 4 segments × 6 steps)."""
    import dataclasses

    p = helpers.default_lgssm()
    rng = np.random.default_rng(7)
    t = 25
    xs, ys = helpers.simulate_lgssm(rng, t_steps=t, batch=3, **p)
    q = p["q_scale"] ** 2 * np.eye(2)
    r = p["r_scale"] ** 2 * np.eye(2)
    s0 = p["s0_scale"] ** 2 * np.eye(2)
    kf = np.array(
        [kalman_filter(ys[b], p["a"], p["c"], q, r, p["mu0"], s0)[0] for b in range(3)]
    )
    rts = np.stack(
        [rts_smoother(ys[b], p["a"], p["c"], q, r, p["mu0"], s0)[0] for b in range(3)]
    )

    cfg, ssm, params = helpers.lgssm_setup(
        objective="psvo", n_particles=2048, n_smoothing=64, t_steps=t, **p
    )
    cfg = dataclasses.replace(
        cfg, smc=dataclasses.replace(cfg.smc, ffbsi_segments=4)
    )
    obj = make_objective(ssm, cfg)
    outs = [jax.jit(obj)(params, jax.random.key(s), jnp.asarray(ys)) for s in range(3)]

    elbo = np.mean([np.asarray(o.elbo) for o in outs], axis=0)
    assert np.all(np.abs(elbo - kf) < 0.7), elbo - kf

    sm = np.mean([np.asarray(o.smoothed) for o in outs], axis=(0, 3))
    sm = np.swapaxes(sm, 0, 1)  # [B, T, Dx]
    assert sm.shape == rts.shape
    rmse = np.sqrt(np.mean((sm - rts) ** 2))
    assert rmse < 0.12, rmse

    # gradients flow through the segmented path
    g = jax.grad(lambda pp: obj(pp, jax.random.key(0), jnp.asarray(ys)).loss)(params)
    gn = sum(float(jnp.sum(jnp.abs(a))) for a in jax.tree_util.tree_leaves(g))
    assert np.isfinite(gn) and gn > 0


def test_svo_is_a_lower_bound(lgssm):
    """With an untrained backward proposal SVO is loose but must stay a bound."""
    out = _run(lgssm, "svo", 1024, m=32)
    assert np.all(np.asarray(out.elbo) < lgssm["kf_loglik"] + 1.0)


def test_numpy_reference_filter_agrees(lgssm):
    """The trusted NumPy reimplementation must hit the same oracle."""
    cfg, ssm, params = helpers.lgssm_setup(
        objective="fivo", n_particles=4096, t_steps=T, **lgssm["p"]
    )
    model = NumpySSMParams.from_jax(params, ssm)
    logz = np.mean(
        [numpy_forward_filter(model, lgssm["ys"], 4096, seed=s) for s in range(3)],
        axis=0,
    )
    err = logz - lgssm["kf_loglik"]
    assert np.all(np.abs(err) < 0.35), err


def test_smoothing_beats_filtering_rmse(lgssm):
    """Smoothed state estimates must beat filtered ones against true latents —
    the self-checking structure the reference relies on (SURVEY.md §4)."""
    out = _run(lgssm, "psvo", 2048, m=64)
    fwd = out.filter_result
    logw_norm = np.asarray(fwd.logws) - jax.scipy.special.logsumexp(
        jnp.asarray(np.asarray(fwd.logws)), axis=-1, keepdims=True
    )
    w = np.exp(np.asarray(logw_norm))  # [T, B, K]
    filt_mean = np.einsum("tbk,tbdk->tbd", w, np.asarray(fwd.xs))
    filt_mean = np.swapaxes(filt_mean, 0, 1)
    sm = np.swapaxes(np.asarray(out.smoothed).mean(2), 0, 1)
    rmse_f = np.sqrt(np.mean((filt_mean - lgssm["xs"]) ** 2))
    rmse_s = np.sqrt(np.mean((sm - lgssm["xs"]) ** 2))
    assert rmse_s < rmse_f * 1.02, (rmse_s, rmse_f)
