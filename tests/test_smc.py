"""Forward-filter invariants + gradient-path consistency (SURVEY.md §4.3)."""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from psvo_tpu.config import Config, DataConfig, SMCConfig
from psvo_tpu.models.ssm import init_ssm
from psvo_tpu.objectives import make_objective
from psvo_tpu.smc import forward_filter


def _tiny_cfg(objective="fivo", resampling="systematic", k=8, t=6):
    return Config(
        name="tiny",
        data=DataConfig(datatype="fhn", dx=2, dy=2, t_steps=t, n_train=4, n_test=2),
        smc=SMCConfig(
            objective=objective,
            n_particles=k,
            n_smoothing_particles=4,
            resampling=resampling,
        ),
    )


def _setup(**kw):
    cfg = _tiny_cfg(**kw)
    ssm, params = init_ssm(cfg, jax.random.key(0))
    ys = jax.random.normal(jax.random.key(1), (3, cfg.data.t_steps, 2))
    return cfg, ssm, params, ys


def test_increments_sum_to_logz_and_shapes():
    cfg, ssm, params, ys = _setup()
    fwd = forward_filter(ssm, params, jax.random.key(2), ys, cfg.smc, cache=True)
    t, b, k = cfg.data.t_steps, 3, cfg.smc.n_particles
    assert fwd.xs.shape == (t, b, 2, k)  # channel-major: K on lanes
    assert fwd.logws.shape == (t, b, k)
    assert fwd.ess.shape == (t, b)
    np.testing.assert_allclose(
        np.asarray(fwd.increments.sum(0)), np.asarray(fwd.log_z), rtol=1e-5
    )
    assert np.all(np.asarray(fwd.ess) >= 1.0 - 1e-4)
    assert np.all(np.asarray(fwd.ess) <= k + 1e-4)


def test_iwae_telescopes_to_final_weights():
    """No resampling: log Ẑ must equal logsumexp of final cumulative weights − log K."""
    cfg, ssm, params, ys = _setup(resampling="none")
    fwd = forward_filter(ssm, params, jax.random.key(2), ys, cfg.smc, cache=True)
    want = jax.scipy.special.logsumexp(fwd.logws[-1], axis=-1) - jnp.log(
        float(cfg.smc.n_particles)
    )
    np.testing.assert_allclose(np.asarray(fwd.log_z), np.asarray(want), rtol=1e-5)


def test_always_resampling_gives_per_step_increments():
    """Per-step resampling: log Ẑ = Σ_t [logsumexp(cached logw_t) − log K]."""
    cfg, ssm, params, ys = _setup(resampling="systematic")
    fwd = forward_filter(ssm, params, jax.random.key(2), ys, cfg.smc, cache=True)
    per_step = jax.scipy.special.logsumexp(fwd.logws, axis=-1) - jnp.log(
        float(cfg.smc.n_particles)
    )
    np.testing.assert_allclose(
        np.asarray(per_step.sum(0)), np.asarray(fwd.log_z), rtol=1e-5
    )


def test_iwae_gradient_matches_finite_differences():
    """SURVEY.md §4.3: the IWAE estimator is fully reparameterized (no
    resampling, no discrete choices), so with a FIXED key its loss is a
    smooth deterministic function of the params — central finite differences
    must reproduce the autodiff directional derivative."""
    cfg, ssm, params, ys = _setup(objective="iwae", resampling="none", t=5)
    obj = make_objective(ssm, cfg)
    key = jax.random.key(3)

    loss = lambda p: obj(p, key, ys).loss
    g = jax.grad(loss)(params)
    # fixed UNIT-norm direction with every leaf populated (an unnormalized
    # direction makes eps·‖v‖ large enough for curvature + relu-kink
    # crossings to bias the difference quotient ~10%)
    direction = jax.tree_util.tree_map(
        lambda a: jnp.asarray(
            np.random.default_rng(0).standard_normal(a.shape), a.dtype
        ),
        params,
    )
    tn = float(
        jnp.sqrt(
            sum(jnp.vdot(v, v).real for v in jax.tree_util.tree_leaves(direction))
        )
    )
    direction = jax.tree_util.tree_map(lambda v: v / tn, direction)
    gv = sum(
        float(jnp.vdot(a, b))
        for a, b in zip(
            jax.tree_util.tree_leaves(g), jax.tree_util.tree_leaves(direction)
        )
    )
    eps = 3e-3  # sweep 3e-2..3e-4 showed <0.2% error here; f32 noise below 1e-3
    shift = lambda s: jax.tree_util.tree_map(
        lambda p, v: p + s * v, params, direction
    )
    fd = (float(loss(shift(eps))) - float(loss(shift(-eps)))) / (2 * eps)
    assert np.isfinite(gv) and np.isfinite(fd)
    np.testing.assert_allclose(gv, fd, rtol=2e-2, atol=1e-4)


def test_fivo_full_gradient_matches_enumeration():
    """SURVEY.md §4.3 second clause: on a 2-step model with K=2 particles and
    FIXED proposal noise, the expectation over the multinomial resampling
    draws is computable by enumeration (3 ancestor multisets), so

        E_a[ ∇̂_full(a) ]  ==  ∇_θ E_a[ log Ẑ(a) ]
        E_a[log Ẑ] = Σ_a P_θ(a)·log Ẑ(a, θ),  P((0,0))=W₀², P((0,1))=2W₀W₁, …

    exactly — validating both the product-categorical score term and its
    future-increments-only baseline (a past-measurable baseline preserves
    unbiasedness; it must drop out of the enumerated expectation)."""
    cfg, ssm, params, ys = _setup(objective="fivo", resampling="multinomial",
                                  k=2, t=2)
    cfg = dataclasses.replace(
        cfg, smc=dataclasses.replace(cfg.smc, use_stop_gradient=False)
    )
    ys = ys[:1]  # B=1
    k = 2
    rng = np.random.default_rng(11)
    eps0 = jnp.asarray(rng.standard_normal((1, 2, k)), jnp.float32)
    eps1 = jnp.asarray(rng.standard_normal((1, 1, 2, k)), jnp.float32)

    def filt(p, u):
        return forward_filter(
            ssm, p, jax.random.key(0), ys, cfg.smc, cache=True,
            noise=(eps0, eps1, u),
        )

    # base-point resampling weights W = softmax(α₀) pick the in-bin u's
    w_base = np.asarray(
        jax.nn.softmax(filt(params, jnp.full((1, 1, k), 0.5)).logws[0], -1)
    )[0]
    w0 = float(w_base[0])
    multisets = {
        (0, 0): ([0.25 * w0, 0.75 * w0], lambda W: W[0] * W[0]),
        (0, 1): ([0.5 * w0, w0 + 0.5 * (1 - w0)], lambda W: 2.0 * W[0] * W[1]),
        (1, 1): (
            [w0 + 0.25 * (1 - w0), w0 + 0.75 * (1 - w0)],
            lambda W: W[1] * W[1],
        ),
    }
    us = {
        a: jnp.asarray(np.array(pos, np.float32))[None, None, :]
        for a, (pos, _) in multisets.items()
    }
    # the u's must actually realize their assignments at the base point
    from psvo_tpu.ops import resampling as res_ops

    cumw = jnp.cumsum(jnp.asarray(w_base, jnp.float32), -1)[None]
    for a, u in us.items():
        got = tuple(np.asarray(res_ops.inverse_cdf_indices(cumw, u[0]))[0])
        assert got == a, (got, a)

    def prob(p, a):
        W = jax.nn.softmax(filt(p, us[a]).logws[0], -1)[0]
        return multisets[a][1](W)

    def logz(p, a):
        return filt(p, us[a]).log_z[0]

    def est(p, a):
        fwd = filt(p, us[a])
        sur = fwd.score_surrogate[0]
        return fwd.log_z[0] + (sur - jax.lax.stop_gradient(sur))

    # true gradient: ∇ Σ_a P(a,θ)·log Ẑ(a,θ)  (u's fixed, in-bin)
    true_g = jax.grad(
        lambda p: sum(prob(p, a) * logz(p, a) for a in multisets)
    )(params)
    # estimator expectation: Σ_a P(a)·∇̂(a) at the base point
    probs = {a: float(prob(params, a)) for a in multisets}
    assert abs(sum(probs.values()) - 1.0) < 1e-5, probs
    est_leaves = None
    for a in multisets:
        g = jax.tree_util.tree_leaves(jax.grad(lambda p: est(p, a))(params))
        scaled = [probs[a] * np.asarray(x) for x in g]
        est_leaves = (
            scaled if est_leaves is None
            else [e + s for e, s in zip(est_leaves, scaled)]
        )
    for got, want in zip(est_leaves, jax.tree_util.tree_leaves(true_g)):
        np.testing.assert_allclose(got, np.asarray(want), rtol=2e-4, atol=2e-5)


def test_grad_reverse_matches_forward_mode():
    """vjp-vs-jvp consistency on every objective — the safety net that will
    catch a wrong custom VJP or gradient rule (SURVEY.md §7 M4)."""
    for objective in ("iwae", "fivo", "svo", "psvo"):
        cfg, ssm, params, ys = _setup(objective=objective)
        obj = make_objective(ssm, cfg)
        key = jax.random.key(3)

        def loss(p):
            return obj(p, key, ys).loss

        grads = jax.grad(loss)(params)
        direction = jax.tree_util.tree_map(
            lambda a: jnp.asarray(
                np.random.default_rng(0).standard_normal(a.shape), a.dtype
            ),
            params,
        )
        _, jvp_val = jax.jvp(loss, (params,), (direction,))
        vjp_dot = sum(
            jnp.vdot(g, d)
            for g, d in zip(
                jax.tree_util.tree_leaves(grads), jax.tree_util.tree_leaves(direction)
            )
        )
        np.testing.assert_allclose(
            float(jvp_val), float(vjp_dot), rtol=2e-3, err_msg=objective
        )


def test_score_function_gradient_path():
    """use_stop_gradient=False adds the REINFORCE resampling term: loss value
    must be unchanged, gradients must differ from the stop-gradient run.
    Multinomial resampling only — the product-categorical ancestor density
    the term uses doesn't exist for systematic resampling."""
    cfg, ssm, params, ys = _setup(objective="fivo", resampling="multinomial")
    cfg_sf = dataclasses.replace(
        cfg, smc=dataclasses.replace(cfg.smc, use_stop_gradient=False)
    )
    ssm_sf, _ = init_ssm(cfg_sf, jax.random.key(0))
    key = jax.random.key(5)

    obj = make_objective(ssm, cfg)
    obj_sf = make_objective(ssm_sf, cfg_sf)
    out = obj(params, key, ys)
    out_sf = obj_sf(params, key, ys)
    np.testing.assert_allclose(
        float(out.loss), float(out_sf.loss), rtol=1e-6
    )  # surrogate is zero-valued

    g = jax.grad(lambda p: obj(p, key, ys).loss)(params)
    g_sf = jax.grad(lambda p: obj_sf(p, key, ys).loss)(params)
    diff = sum(
        float(jnp.sum(jnp.abs(a - b)))
        for a, b in zip(jax.tree_util.tree_leaves(g), jax.tree_util.tree_leaves(g_sf))
    )
    assert diff > 1e-6  # the score term actually contributes
    # and both remain vjp/jvp-consistent
    for o, c, s in ((obj, cfg, ssm), (obj_sf, cfg_sf, ssm_sf)):
        gs = jax.grad(lambda p: o(p, key, ys).loss)(params)
        assert all(
            np.all(np.isfinite(np.asarray(x))) for x in jax.tree_util.tree_leaves(gs)
        )
    # systematic resampling + the full gradient is a mis-specified estimator:
    # construction must refuse it.
    cfg_bad = _tiny_cfg(objective="fivo", resampling="systematic")
    cfg_bad = dataclasses.replace(
        cfg_bad, smc=dataclasses.replace(cfg_bad.smc, use_stop_gradient=False)
    )
    ssm_bad, _ = init_ssm(cfg_bad, jax.random.key(0))
    try:
        make_objective(ssm_bad, cfg_bad)
        assert False, "expected ValueError for systematic + use_stop_gradient=False"
    except ValueError:
        pass


def test_bootstrap_mode_runs():
    cfg = _tiny_cfg()
    cfg = dataclasses.replace(cfg, smc=dataclasses.replace(cfg.smc, use_bootstrap=True))
    ssm, params = init_ssm(cfg, jax.random.key(0))
    ys = jax.random.normal(jax.random.key(1), (2, cfg.data.t_steps, 2))
    fwd = forward_filter(ssm, params, jax.random.key(2), ys, cfg.smc)
    assert np.all(np.isfinite(np.asarray(fwd.log_z)))


def test_use_2q_off_runs():
    cfg = _tiny_cfg()
    cfg = dataclasses.replace(cfg, smc=dataclasses.replace(cfg.smc, use_2q=False))
    ssm, params = init_ssm(cfg, jax.random.key(0))
    ys = jax.random.normal(jax.random.key(1), (2, cfg.data.t_steps, 2))
    fwd = forward_filter(ssm, params, jax.random.key(2), ys, cfg.smc)
    assert np.all(np.isfinite(np.asarray(fwd.log_z)))


def test_encoder_inputs_override():
    """q_uses_true_X debug path: feeding different encoder inputs changes the run."""
    cfg, ssm, params, ys = _setup()
    f1 = forward_filter(ssm, params, jax.random.key(2), ys, cfg.smc)
    f2 = forward_filter(
        ssm, params, jax.random.key(2), ys, cfg.smc, encoder_inputs=ys * 0.5
    )
    assert not np.allclose(np.asarray(f1.log_z), np.asarray(f2.log_z))


def test_svo_qb_rnn_backward_proposal():
    """SVO's RNN-parameterized backward proposal (smc.qb_rnn — SURVEY.md
    §2-A q_b "MLP/RNN-parameterized"): the GRU summary must change the
    objective, carry gradients into the GRU parameters, and the vjp/jvp
    consistency that guards every estimator must hold."""
    cfg, ssm, params, ys = _setup(objective="svo")
    cfg_rnn = dataclasses.replace(
        cfg, smc=dataclasses.replace(cfg.smc, qb_rnn=True)
    )
    ssm_rnn, params_rnn = init_ssm(cfg_rnn, jax.random.key(0))
    assert "qb_rnn" in params_rnn and "qb_rnn" not in params

    # the summary pass has the right shape and consumes the observations
    hs = ssm_rnn.backward_rnn_summaries(params_rnn, jnp.swapaxes(ys, 0, 1))
    assert hs.shape == (cfg.data.t_steps, ys.shape[0], ssm_rnn.qb_rnn_dim)
    ys2 = ys.at[:, -1].add(1.0)  # h_t summarizes y_{t:T}: last obs affects all t
    hs2 = ssm_rnn.backward_rnn_summaries(params_rnn, jnp.swapaxes(ys2, 0, 1))
    assert not np.allclose(np.asarray(hs), np.asarray(hs2))

    obj = make_objective(ssm_rnn, cfg_rnn)
    key = jax.random.key(3)

    def loss(p):
        return obj(p, key, ys).loss

    val, grads = jax.value_and_grad(loss)(params_rnn)
    assert np.isfinite(float(val))
    gru_norm = sum(
        float(jnp.sum(jnp.abs(g)))
        for g in jax.tree_util.tree_leaves(grads["qb_rnn"])
    )
    assert gru_norm > 0.0  # the GRU is in the gradient path

    # vjp-vs-jvp consistency (the estimator safety net, as in
    # test_grad_reverse_matches_forward_mode)
    direction = jax.tree_util.tree_map(
        lambda a: jnp.asarray(
            np.random.default_rng(0).standard_normal(a.shape), a.dtype
        ),
        params_rnn,
    )
    _, jvp_val = jax.jvp(loss, (params_rnn,), (direction,))
    vjp_dot = sum(
        jnp.vdot(g, d)
        for g, d in zip(
            jax.tree_util.tree_leaves(grads), jax.tree_util.tree_leaves(direction)
        )
    )
    np.testing.assert_allclose(float(jvp_val), float(vjp_dot), rtol=2e-3)

    # missing-summary misuse fails loudly
    with pytest.raises(ValueError, match="qb_rnn"):
        ssm_rnn.backward_propose(
            params_rnn, jnp.zeros((3, 4, 2)), jnp.zeros((3, 1, 2))
        )
