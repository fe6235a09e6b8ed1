"""The plain JAX path against NumPy references: resampling + ancestor gather
(with its scatter-add gradient), the forward filter draw for draw, the
segmented long-T path against the unsegmented one, and one train step of
every preset."""

from __future__ import annotations

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from psvo_tpu import smc
from psvo_tpu.config import PRESETS, Config, DataConfig, NetConfig, SMCConfig
from psvo_tpu.models.ssm import init_ssm
from psvo_tpu.ops import resampling
from tests.reference_numpy.numpy_smc import NumpySSMParams, numpy_forward_filter

# ---------------------------------------------------------------------------
# resampling + ancestor gather
# ---------------------------------------------------------------------------


def _positions(rng, method, batch, k):
    u_raw = rng.uniform(size=(batch,) if method == "systematic" else (batch, k))
    return resampling.quantile_positions_from_raw(
        jnp.asarray(u_raw.astype(np.float32)), k, method
    )


def _oracle(logw, u):
    """float64 NumPy inverse CDF: a_i = #{j : C_j <= u_i}, clipped; also
    returns the CDF."""
    lw = np.asarray(logw, np.float64)
    w = np.exp(lw - lw.max(-1, keepdims=True))
    cumw = np.cumsum(w / w.sum(-1, keepdims=True), axis=-1)
    u = np.asarray(u, np.float64)
    idx = np.stack([np.searchsorted(c, q, side="right") for c, q in zip(cumw, u)])
    return np.minimum(idx, lw.shape[-1] - 1), cumw


def _resample(u, logw, x, method):
    return resampling.maybe_resample(u, logw, x, method=method)


@pytest.mark.parametrize("method", ["systematic", "multinomial"])
@pytest.mark.parametrize("k,d", [(16, 2), (128, 3), (1024, 11), (8192, 2), (8192, 40)])
def test_resample_and_gather_matches_numpy_oracle(method, k, d):
    rng = np.random.default_rng(k + d)
    batch = 4
    logw = jnp.asarray(rng.standard_normal((batch, k)).astype(np.float32) * 2)
    x = jnp.asarray(rng.standard_normal((batch, d, k)).astype(np.float32))
    u = _positions(rng, method, batch, k)
    x_res, logw_out, did, ess, idx = jax.jit(_resample, static_argnums=3)(
        u, logw, x, method
    )
    got = np.asarray(idx).astype(np.int64)
    want, cumw = _oracle(logw, u)
    assert np.mean(got == want) > 0.99, np.mean(got == want)
    # where they differ, the f32 CDF sum moved a bin edge past u: the chosen
    # ancestor's float64 bin [C_{a-1}, C_a) still holds u up to that error
    lo = np.take_along_axis(np.pad(cumw, ((0, 0), (1, 0))), got, -1)
    hi = np.take_along_axis(cumw, got, -1)
    uu = np.asarray(u, np.float64)
    assert np.all(lo - 1e-4 <= uu) and np.all((uu < hi + 1e-4) | (got == k - 1))
    # the gather is exactly the selection by the returned indices
    np.testing.assert_array_equal(
        np.asarray(x_res), np.take_along_axis(np.asarray(x), got[:, None, :], -1)
    )
    np.testing.assert_array_equal(np.asarray(logw_out), 0.0)
    assert np.all(np.asarray(did))
    assert np.all(np.diff(got, axis=-1) >= 0)  # sorted positions, sorted ancestors
    w = np.exp(np.asarray(logw, np.float64))
    np.testing.assert_allclose(
        np.asarray(ess), w.sum(-1) ** 2 / (w * w).sum(-1), rtol=1e-4
    )


@pytest.mark.parametrize("method", ["systematic", "multinomial"])
@pytest.mark.parametrize("k", [256, 8192])
def test_resample_degenerate_weights(method, k):
    """ESS = 1: all mass on one particle; every ancestor is that particle,
    and the ESS test fires at any threshold."""
    rng = np.random.default_rng(1)
    batch, d, hot = 3, 2, k // 3
    logw = jnp.where(jnp.arange(k) == hot, 0.0, -200.0)[None].repeat(batch, 0)
    x = jnp.asarray(rng.standard_normal((batch, d, k)).astype(np.float32))
    u = _positions(rng, method, batch, k)
    x_res, _, did, ess, idx = resampling.maybe_resample(
        u, logw, x, method=method, ess_threshold=0.5
    )
    np.testing.assert_array_equal(np.asarray(idx), hot)
    np.testing.assert_array_equal(
        np.asarray(x_res), np.broadcast_to(np.asarray(x[:, :, hot : hot + 1]), x.shape)
    )
    assert np.all(np.asarray(did))
    np.testing.assert_allclose(np.asarray(ess), 1.0, rtol=1e-5)


@pytest.mark.parametrize("method", ["systematic", "multinomial"])
@pytest.mark.parametrize("k", [128, 2048])
def test_resample_gather_gradient_is_exact_scatter_add(method, k):
    """d/dx of the gathered particles is the scatter-add of the cotangent
    onto the chosen ancestors; the discrete choice passes no gradient to
    the log-weights."""
    rng = np.random.default_rng(6)
    batch, d = 4, 3
    logw = jnp.asarray(rng.standard_normal((batch, k)).astype(np.float32))
    x = jnp.asarray(rng.standard_normal((batch, d, k)).astype(np.float32))
    u = _positions(rng, method, batch, k)
    cot = rng.standard_normal((batch, d, k)).astype(np.float32)

    def f(x, lw):
        return jnp.sum(_resample(u, lw, x, method)[0] * cot)

    gx, glw = jax.grad(f, argnums=(0, 1))(x, logw)
    idx = np.asarray(_resample(u, logw, x, method)[4])
    want = np.zeros((batch, d, k), np.float32)
    for b in range(batch):
        np.add.at(want[b].T, idx[b], cot[b].T)
    np.testing.assert_allclose(np.asarray(gx), want, rtol=1e-6, atol=1e-6)
    np.testing.assert_array_equal(np.asarray(glw), 0.0)


# ---------------------------------------------------------------------------
# forward filter against the NumPy filter, draw for draw
# ---------------------------------------------------------------------------


def _filter_cfg(objective, use_2q, hidden, di):
    net = NetConfig(hidden=hidden)
    return Config(
        name="plain_vs_numpy",
        data=DataConfig(datatype="fhn", dx=2, dy=2, di=di, t_steps=8),
        smc=SMCConfig(
            objective=objective,
            n_particles=32,
            resampling="none" if objective == "iwae" else "systematic",
            use_2q=use_2q,
        ),
    ).with_nets(q0=net, q1=net, q2=net, f=net, g=dataclasses.replace(net, sigma_init=0.5))


@pytest.mark.parametrize("di", [0, 2])
@pytest.mark.parametrize("hidden", [(), (16,)])
@pytest.mark.parametrize("use_2q", [True, False])
@pytest.mark.parametrize("objective", ["iwae", "fivo"])
def test_forward_filter_matches_numpy_with_identical_noise(objective, use_2q, hidden, di):
    cfg = _filter_cfg(objective, use_2q, hidden, di)
    ssm, params = init_ssm(cfg, jax.random.key(0))
    rng = np.random.default_rng(3)
    b, t, k = 3, cfg.data.t_steps, cfg.smc.n_particles
    ys = jnp.asarray(rng.standard_normal((b, t, 2)).astype(np.float32))
    ctrl = jnp.asarray(rng.standard_normal((b, t, di)).astype(np.float32)) if di else None
    eps0 = jnp.asarray(rng.standard_normal((b, 2, k)).astype(np.float32))
    eps = jnp.asarray(rng.standard_normal((t - 1, b, 2, k)).astype(np.float32))
    if objective == "iwae":
        u = jnp.zeros((t - 1, b, 1))
    else:
        u = resampling.quantile_positions_from_raw(
            jnp.asarray(rng.uniform(size=(t - 1, b)).astype(np.float32)), k, "systematic"
        )
    fwd = smc.forward_filter(
        ssm, params, jax.random.key(9), ys, cfg.smc, controls=ctrl, noise=(eps0, eps, u)
    )
    want = numpy_forward_filter(
        NumpySSMParams.from_jax(params, ssm),
        np.asarray(ys, np.float64),
        k,
        resampling=cfg.smc.resampling,
        noise=(eps0, eps, u),
        controls=None if ctrl is None else np.asarray(ctrl, np.float64),
    )
    np.testing.assert_allclose(np.asarray(fwd.log_z), want, rtol=1e-4, atol=1e-3)
    assert fwd.increments.shape == (t, b)


# ---------------------------------------------------------------------------
# segmented (long-T) path against the unsegmented one
# ---------------------------------------------------------------------------


def _seg_setup(objective, t=7):
    net = NetConfig(hidden=(8,))
    cfg = Config(
        name="seg",
        data=DataConfig(datatype="lorenz63", dx=3, dy=3, t_steps=t),
        smc=SMCConfig(
            objective=objective,
            n_particles=16,
            n_smoothing_particles=4,
            resampling="none" if objective == "iwae" else "systematic",
        ),
    ).with_nets(q0=net, q1=net, q2=net, f=net, g=net, qb=net)
    ssm, params = init_ssm(cfg, jax.random.key(0))
    ys = jax.random.normal(jax.random.key(1), (2, t, 3))
    return cfg, ssm, params, ys


def _segment_noise(ssm, cfg, key, b, t, n_segments):
    """The draws forward_filter_segmented makes, as one full-T noise tuple."""
    k = cfg.smc.n_particles
    k0, k_prop, k_res = jax.random.split(key, 3)
    seg_len = (t - 1) // n_segments
    parts = [
        smc._segment_randomness(ssm, cfg.smc, kp, kr, seg_len, b, k)
        for kp, kr in zip(
            jax.random.split(k_prop, n_segments), jax.random.split(k_res, n_segments)
        )
    ]
    eps0 = jax.random.normal(k0, (b, ssm.dx, k))
    return (
        eps0,
        jnp.concatenate([e for e, _ in parts]),
        jnp.concatenate([u for _, u in parts]),
    )


@pytest.mark.parametrize("n_segments", [2, 3, 6])
@pytest.mark.parametrize("objective", ["iwae", "fivo", "psvo"])
def test_segmented_matches_unsegmented(objective, n_segments):
    """Same draws in, same numbers out: the segmented forward (boundary
    carries + per-segment streams) against the plain scan fed the same
    streams, and for PSVO the segmented FFBSi sweep (in-backward segment
    recompute) against the full-cache sweep."""
    from psvo_tpu import objectives

    cfg, ssm, params, ys = _seg_setup(objective)
    b, t = ys.shape[0], ys.shape[1]
    key = jax.random.key(5)
    noise = _segment_noise(ssm, cfg, key, b, t, n_segments)
    seg, cache = smc.forward_filter_segmented(ssm, params, key, ys, cfg.smc, n_segments)
    full = smc.forward_filter(ssm, params, key, ys, cfg.smc, cache=True, noise=noise)
    for name in ("log_z", "increments", "ess", "x_last", "logw_last", "filtered_means"):
        np.testing.assert_array_equal(
            np.asarray(getattr(seg, name)), np.asarray(getattr(full, name)), err_msg=name
        )
    if objective != "psvo":
        return
    ys_tm = jnp.swapaxes(ys, 0, 1)
    ctrl_tm = smc._controls_tm(None, b, t, ssm.di)
    kb = jax.random.key(6)
    a = objectives._ffbsi_backward(ssm, params, kb, ys_tm, ctrl_tm, full, 4)
    s = objectives._ffbsi_backward_segmented(
        ssm, params, kb, ys_tm, ys_tm, ctrl_tm, seg, cache, 4, cfg.smc
    )
    for name, x, y in zip(("smoothed", "logp", "logq"), a, s):
        np.testing.assert_allclose(
            np.asarray(y), np.asarray(x), rtol=1e-6, atol=1e-6, err_msg=name
        )


# ---------------------------------------------------------------------------
# every preset takes a train step
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("name", sorted(PRESETS))
def test_every_preset_takes_a_train_step(name):
    """Each preset at reduced K/T/B (its other settings as shipped) takes one
    jitted train step: finite loss, finite gradients, params move."""
    from psvo_tpu.data import generate_dataset
    from psvo_tpu.train import make_optimizer, make_train_step

    cfg = PRESETS[name]
    cfg = dataclasses.replace(
        cfg,
        data=dataclasses.replace(cfg.data, t_steps=5, n_train=4, n_test=2),
        smc=dataclasses.replace(cfg.smc, n_particles=16, n_smoothing_particles=4),
        train=dataclasses.replace(cfg.train, batch_size=2, steps_per_call=1),
        mesh=dataclasses.replace(cfg.mesh, data=1, particle=1),
    )
    ds = generate_dataset(cfg.data, cfg.seed)
    ssm, params = init_ssm(cfg, jax.random.key(0))
    opt = make_optimizer(cfg)
    step = make_train_step(ssm, cfg, opt)
    ctrl = jnp.asarray(ds.controls_train[:2]) if cfg.data.di else None
    p2, _, m = step(
        params, opt.init(params), jax.random.key(1), jnp.asarray(ds.obs_train[:2]),
        None, ctrl,
    )
    assert np.isfinite(float(m["loss"])) and np.isfinite(float(m["grad_norm"]))
    moved = sum(
        float(jnp.sum(jnp.abs(a - b)))
        for a, b in zip(jax.tree_util.tree_leaves(params), jax.tree_util.tree_leaves(p2))
    )
    assert moved > 0
