"""Reference capability-parity modes (SURVEY.md §2-A / §5 flag table):
full-covariance (tril) heads with a Kalman/RTS oracle, Dirac-delta emissions,
exogenous control inputs (Di), the known-dynamics transition ablation, and
epoch-accounting training."""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from psvo_tpu.config import Config, DataConfig, NetConfig, SMCConfig, TrainConfig
from psvo_tpu.data import generate_dataset, load_dataset, save_dataset
from psvo_tpu.models.dynamics import make_stepper
from psvo_tpu.models.ssm import init_ssm
from psvo_tpu.objectives import make_objective
from psvo_tpu.train import Trainer, make_eval_step
from tests import helpers
from tests.reference_numpy import kalman_filter, rts_smoother


def _full_cov_case():
    theta = 0.4
    a = 0.85 * np.array(
        [[np.cos(theta), -np.sin(theta)], [np.sin(theta), np.cos(theta)]], np.float32
    )
    c = np.eye(2, dtype=np.float32)
    q_chol = np.array([[0.5, 0.0], [0.3, 0.4]], np.float32)
    r_chol = np.array([[0.4, 0.0], [-0.2, 0.3]], np.float32)
    mu0 = np.zeros(2, np.float32)
    return a, c, q_chol, r_chol, mu0


def test_tril_heads_match_kalman_oracle():
    """Bootstrap PF with cov_type='tril' transition+emission set to the true
    correlated-noise LGSSM must reproduce the exact Kalman log-likelihood."""
    a, c, q_chol, r_chol, mu0 = _full_cov_case()
    rng = np.random.default_rng(11)
    t = 20
    xs, ys = helpers.simulate_lgssm_full(rng, a, c, q_chol, r_chol, mu0, 1.0, t, 3)
    q = q_chol @ q_chol.T
    r = r_chol @ r_chol.T
    kf = np.array(
        [kalman_filter(ys[b], a, c, q, r, mu0, np.eye(2))[0] for b in range(3)]
    )

    cfg, ssm, params = helpers.lgssm_full_setup(
        a=a, c=c, q_chol=q_chol, r_chol=r_chol, mu0=mu0, s0_scale=1.0,
        n_particles=2048, t_steps=t,
    )
    obj = make_objective(ssm, cfg)
    outs = [
        np.asarray(jax.jit(obj)(params, jax.random.key(s), jnp.asarray(ys)).elbo)
        for s in range(4)
    ]
    err = np.mean(outs, axis=0) - kf
    assert np.all(np.abs(err) < 0.5), err


def test_tril_psvo_smoothed_means_match_rts():
    """FFBSi over the tril (whitened pairwise) path hits the RTS oracle with
    correlated noise."""
    a, c, q_chol, r_chol, mu0 = _full_cov_case()
    rng = np.random.default_rng(12)
    t = 20
    xs, ys = helpers.simulate_lgssm_full(rng, a, c, q_chol, r_chol, mu0, 1.0, t, 3)
    q = q_chol @ q_chol.T
    r = r_chol @ r_chol.T
    rts = np.stack(
        [rts_smoother(ys[b], a, c, q, r, mu0, np.eye(2))[0] for b in range(3)]
    )

    cfg, ssm, params = helpers.lgssm_full_setup(
        a=a, c=c, q_chol=q_chol, r_chol=r_chol, mu0=mu0, s0_scale=1.0,
        objective="psvo", n_particles=2048, n_smoothing=64, t_steps=t,
    )
    obj = make_objective(ssm, cfg)
    outs = [jax.jit(obj)(params, jax.random.key(s), jnp.asarray(ys)) for s in range(3)]
    sm = np.mean([np.asarray(o.smoothed) for o in outs], axis=(0, 3))
    sm = np.swapaxes(sm, 0, 1)  # [B, T, Dx]
    rmse = np.sqrt(np.mean((sm - rts) ** 2))
    assert rmse < 0.15, rmse


def test_known_dynamics_transition():
    """transition='known': f's mean IS the true stepper; only the noise scale
    is learnable; proposal-only training still improves the bound."""
    cfg = Config(
        name="known",
        data=DataConfig(datatype="fhn", dx=2, dy=2, t_steps=12, n_train=16, n_test=8),
        smc=SMCConfig(objective="fivo", n_particles=16, transition="known"),
        train=TrainConfig(batch_size=8, n_steps=60, eval_every=30, lr=3e-3),
    )
    ssm, params = init_ssm(cfg, jax.random.key(0))
    assert set(params["f"].keys()) == {"raw_scale"}  # no MLP — frozen dynamics

    stepper = make_stepper(cfg.data)
    x = jax.random.normal(jax.random.key(1), (4, 2))
    mean, scale = ssm.transition_params(params, x)
    np.testing.assert_allclose(np.asarray(mean), np.asarray(stepper.step(x)), rtol=1e-6)
    # channel-major variant agrees with the feature-last stepper
    x_cm = jax.random.normal(jax.random.key(2), (3, 2, 8))
    mean_cm = ssm.transition_params_cm(params, x_cm)[0]
    want = jnp.moveaxis(stepper.step(jnp.moveaxis(x_cm, -2, -1)), -1, -2)
    np.testing.assert_allclose(np.asarray(mean_cm), np.asarray(want), rtol=1e-5, atol=1e-6)

    ds = generate_dataset(cfg.data, 0)
    trainer = Trainer(cfg, ssm, params)
    hist = trainer.run(ds.obs_train, ds.obs_test)
    # keep_best retains the best snapshot even if a later eval degenerates
    assert np.isfinite(trainer.state.best_elbo)
    assert trainer.state.best_elbo >= hist[0]["test_elbo"] - 1e-6


def test_known_dynamics_with_controls():
    """transition='known' + di>0: the mean is the true stepper plus a learned
    additive drift B_u·u_t, zero-initialized (so t=0 matches the pure known
    dynamics exactly), and training recovers a control effect — the trained
    model fits better under the TRUE controls than permuted ones."""
    cfg = Config(
        name="known_ctrl",
        data=DataConfig(
            datatype="fhn", dx=2, dy=2, di=2, control_scale=1.0,
            t_steps=12, n_train=48, n_test=12, proc_scale=0.15,
        ),
        smc=SMCConfig(objective="fivo", n_particles=16, transition="known"),
        train=TrainConfig(batch_size=16, n_steps=150, eval_every=75, lr=3e-3),
    )
    ssm, params = init_ssm(cfg, jax.random.key(0))
    assert set(params["f"].keys()) == {"raw_scale", "ctrl_w"}

    # exact drift math, feature-last and channel-major
    stepper = make_stepper(cfg.data)
    w = jnp.asarray([[0.3, -0.2], [0.1, 0.4]])
    p2 = {**params, "f": {**params["f"], "ctrl_w": w}}
    x = jax.random.normal(jax.random.key(1), (4, 2))
    u = jax.random.normal(jax.random.key(2), (4, 2))
    mean, _ = ssm.transition_params(p2, x, u)
    np.testing.assert_allclose(
        np.asarray(mean), np.asarray(stepper.step(x) + u @ w), rtol=1e-6
    )
    x_cm = jax.random.normal(jax.random.key(3), (4, 2, 8))
    mean_cm = ssm.transition_params_cm(p2, x_cm, u)[0]
    want = jnp.moveaxis(
        stepper.step(jnp.moveaxis(x_cm, -2, -1)) + (u @ w)[:, None, :], -1, -2
    )
    np.testing.assert_allclose(
        np.asarray(mean_cm), np.asarray(want), rtol=1e-5, atol=1e-6
    )
    # zero-init: with no training the drift is exactly zero
    mean0, _ = ssm.transition_params(params, x, u)
    np.testing.assert_allclose(
        np.asarray(mean0), np.asarray(stepper.step(x)), rtol=1e-6
    )

    ds = generate_dataset(cfg.data, 0)
    trainer = Trainer(cfg, ssm, params)
    trainer.run(
        ds.obs_train, ds.obs_test,
        controls_train=ds.controls_train, controls_test=ds.controls_test,
    )
    ev = make_eval_step(ssm, cfg)
    key = jax.random.key(9)
    true_elbo = float(
        ev(trainer.state.params, key, jnp.asarray(ds.obs_test), None,
           jnp.asarray(ds.controls_test))["elbo"]
    )
    permuted = jnp.asarray(np.asarray(ds.controls_test)[:, ::-1])
    perm_elbo = float(
        ev(trainer.state.params, key, jnp.asarray(ds.obs_test), None, permuted)["elbo"]
    )
    assert np.isfinite(true_elbo)
    assert true_elbo > perm_elbo + 0.5, (true_elbo, perm_elbo)


def test_dirac_emission_pipeline():
    """emission='dirac': noiseless observation map, zero density contribution."""
    cfg = Config(
        name="dirac",
        data=DataConfig(
            datatype="fhn", dx=2, dy=2, t_steps=10, n_train=8, n_test=4,
            emission="dirac",
        ),
        smc=SMCConfig(objective="fivo", n_particles=8),
    )
    ds = generate_dataset(cfg.data, 0)
    # the data really is deterministic: y == x @ C exactly
    np.testing.assert_allclose(
        np.asarray(ds.obs_test),
        np.asarray(ds.hidden_test @ ds.emission_matrix),
        rtol=1e-6,
    )
    ssm, params = init_ssm(cfg, jax.random.key(0))
    x = jax.random.normal(jax.random.key(1), (3, 4, 2))
    y = jax.random.normal(jax.random.key(2), (3, 4, 2))
    np.testing.assert_array_equal(
        np.asarray(ssm.emission_log_prob(params, x, y)), 0.0
    )
    x_cm = jax.random.normal(jax.random.key(3), (3, 2, 8))
    np.testing.assert_array_equal(
        np.asarray(ssm.emission_log_prob_cm(params, x_cm, y[:, 0])), 0.0
    )
    out = make_objective(ssm, cfg)(params, jax.random.key(4), jnp.asarray(ds.obs_test))
    assert np.isfinite(float(out.loss))


def test_controls_enter_the_model():
    """With a strong true control effect, a trained model must fit the data
    better under the TRUE controls than under permuted ones — proving the
    control inputs actually condition the learned transition."""
    cfg = Config(
        name="ctrl",
        data=DataConfig(
            datatype="fhn", dx=2, dy=2, di=2, control_scale=1.0,
            t_steps=12, n_train=48, n_test=12, proc_scale=0.15,
        ),
        smc=SMCConfig(objective="fivo", n_particles=16),
        train=TrainConfig(batch_size=16, n_steps=150, eval_every=75, lr=3e-3),
    )
    ds = generate_dataset(cfg.data, 0)
    assert ds.controls_train.shape == (48, 12, 2)
    ssm, params = init_ssm(cfg, jax.random.key(0))
    trainer = Trainer(cfg, ssm, params)
    trainer.run(
        ds.obs_train, ds.obs_test,
        controls_train=ds.controls_train, controls_test=ds.controls_test,
    )
    ev = make_eval_step(ssm, cfg)
    key = jax.random.key(9)
    true_elbo = float(
        ev(trainer.state.params, key, jnp.asarray(ds.obs_test), None,
           jnp.asarray(ds.controls_test))["elbo"]
    )
    permuted = jnp.asarray(np.asarray(ds.controls_test)[:, ::-1])  # time-reversed
    perm_elbo = float(
        ev(trainer.state.params, key, jnp.asarray(ds.obs_test), None, permuted)["elbo"]
    )
    assert np.isfinite(true_elbo)
    assert true_elbo > perm_elbo + 0.5, (true_elbo, perm_elbo)


def test_controls_dataset_roundtrip(tmp_path):
    cfg = DataConfig(datatype="fhn", dx=2, dy=2, di=3, t_steps=6, n_train=4, n_test=2)
    ds = generate_dataset(cfg, 0)
    save_dataset(ds, tmp_path / "d.npz")
    back = load_dataset(tmp_path / "d.npz")
    np.testing.assert_array_equal(
        np.asarray(ds.controls_train), np.asarray(back.controls_train)
    )
    np.testing.assert_array_equal(
        np.asarray(ds.control_matrix), np.asarray(back.control_matrix)
    )
    # di=0 datasets still roundtrip with absent control fields
    ds0 = generate_dataset(dataclasses.replace(cfg, di=0), 0)
    save_dataset(ds0, tmp_path / "d0.npz")
    assert load_dataset(tmp_path / "d0.npz").controls_train is None


def test_epoch_mode_resume(tmp_path):
    """Resuming an epoch-mode run continues the step count to the epoch total."""
    from psvo_tpu.utils.checkpoint import Checkpointer

    cfg = Config(
        name="ep_resume",
        data=DataConfig(datatype="fhn", dx=2, dy=2, t_steps=6, n_train=8, n_test=4),
        smc=SMCConfig(objective="fivo", n_particles=8),
        train=TrainConfig(batch_size=4, epochs=3, eval_every=2, save_every=2),
    )
    ds = generate_dataset(cfg.data, 0)
    ssm, params = init_ssm(cfg, jax.random.key(0))
    t1 = Trainer(cfg, ssm, params, checkpointer=Checkpointer(tmp_path, cfg.resume_hash()))
    t1.run(ds.obs_train, ds.obs_test, n_steps=2)  # stop mid-epoch-schedule
    assert t1.state.step == 2

    t2 = Trainer(cfg, ssm, params, checkpointer=Checkpointer(tmp_path, cfg.resume_hash()))
    assert t2.restore() == 2
    t2.run(ds.obs_train, ds.obs_test)  # completes 3 epochs x 2 steps
    assert t2.state.step == 6


def test_epoch_accounting():
    """epochs>0: exactly epochs * floor(n_train/bsz) steps, each epoch a
    without-replacement sweep."""
    cfg = Config(
        name="ep",
        data=DataConfig(datatype="fhn", dx=2, dy=2, t_steps=6, n_train=8, n_test=4),
        smc=SMCConfig(objective="fivo", n_particles=8),
        train=TrainConfig(batch_size=4, epochs=2, eval_every=2),
    )
    ds = generate_dataset(cfg.data, 0)
    ssm, params = init_ssm(cfg, jax.random.key(0))
    trainer = Trainer(cfg, ssm, params)
    trainer.run(ds.obs_train, ds.obs_test)
    assert trainer.state.step == 4  # 2 epochs x (8 / 4)


def test_tril_pairwise_matches_direct_density():
    """The whitened three-matmul pairwise form equals the direct full-cov
    density evaluated pairwise."""
    from psvo_tpu.distributions import mvn_full_log_prob
    from psvo_tpu.objectives import _pairwise_transition_logp

    cfg = Config(
        name="pw",
        data=DataConfig(datatype="fhn", dx=3, dy=3, t_steps=4),
        smc=SMCConfig(objective="psvo", n_particles=16),
    ).with_nets(f=NetConfig(cov_type="tril", hidden=(8,), sigma_init=0.7))
    ssm, params = init_ssm(cfg, jax.random.key(0))
    xs = jax.random.normal(jax.random.key(1), (2, 3, 16))  # [B, D, K]
    xq = jax.random.normal(jax.random.key(2), (2, 5, 3))  # [B, M, D]
    got = np.asarray(_pairwise_transition_logp(ssm, params, xs, xq))
    mean, chol = ssm.transition_full_cm(params, xs)
    mean_fl = jnp.swapaxes(mean, -1, -2)  # [B, K, D]
    want = np.asarray(
        mvn_full_log_prob(xq[:, :, None, :], mean_fl[:, None, :, :], chol)
    )
    np.testing.assert_allclose(got, want, rtol=2e-4, atol=2e-4)


def _zeroed_trilhead(head, mat, chol, sigma_min=1e-3):
    """Set a hidden=() tril_head to an exact CONSTANT (mat, chol): zero head
    weights, biases carrying the Cholesky entries."""
    from tests.helpers import raw_from_scale

    d = chol.shape[0]
    head["mean"] = (jnp.asarray(mat.T, jnp.float32), jnp.zeros((mat.shape[0],)))
    wd, _ = head["tril_diag_head"]
    head["tril_diag_head"] = (
        jnp.zeros_like(wd),
        jnp.asarray(
            [raw_from_scale(float(chol[i, i]), sigma_min) for i in range(d)],
            jnp.float32,
        ),
    )
    rows, cols = np.tril_indices(d, k=-1)
    wo, _ = head["tril_off_head"]
    head["tril_off_head"] = (
        jnp.zeros_like(wo), jnp.asarray(chol[rows, cols], jnp.float32)
    )


def test_trilhead_matches_kalman_oracle():
    """cov_type='tril_head' with zeroed head weights degenerates to the exact
    constant correlated-noise LGSSM — the bootstrap PF through the packed
    per-particle Cholesky path (mvn_tril_sample_cm + mvn_tril_log_prob_cm)
    must reproduce the Kalman log-likelihood, like the constant-tril test."""
    from tests.helpers import SIGMA_MIN, raw_from_scale

    a, c, q_chol, r_chol, mu0 = _full_cov_case()
    rng = np.random.default_rng(11)
    t = 20
    xs, ys = helpers.simulate_lgssm_full(rng, a, c, q_chol, r_chol, mu0, 1.0, t, 3)
    q = q_chol @ q_chol.T
    r = r_chol @ r_chol.T
    kf = np.array(
        [kalman_filter(ys[b], a, c, q, r, mu0, np.eye(2))[0] for b in range(3)]
    )

    lin = NetConfig(hidden=(), cov_type="const", sigma_init=1.0, sigma_min=SIGMA_MIN)
    th = NetConfig(hidden=(), cov_type="tril_head", sigma_init=1.0, sigma_min=SIGMA_MIN)
    cfg = Config(
        name="lgssm_trilhead_oracle",
        data=DataConfig(datatype="lgssm", dx=2, dy=2, t_steps=t),
        smc=SMCConfig(
            objective="fivo", n_particles=2048,
            resampling="systematic", use_bootstrap=True,
        ),
    ).with_nets(q0=lin, q1=lin, q2=lin, f=th, g=th, qb=lin)
    from psvo_tpu.models.ssm import SSM

    ssm = SSM(cfg)
    params = ssm.init(jax.random.key(0))
    _zeroed_trilhead(params["f"], a, q_chol, SIGMA_MIN)
    _zeroed_trilhead(params["g"], c, r_chol, SIGMA_MIN)
    params["prior"]["mean"] = jnp.asarray(mu0, jnp.float32)
    params["prior"]["raw_scale"] = jnp.full((2,), raw_from_scale(1.0, 1e-3))

    obj = make_objective(ssm, cfg)
    outs = [
        np.asarray(jax.jit(obj)(params, jax.random.key(s), jnp.asarray(ys)).elbo)
        for s in range(4)
    ]
    err = np.mean(outs, axis=0) - kf
    assert np.all(np.abs(err) < 0.5), err


def test_trilhead_density_sample_match_numpy():
    """State-dependent packed-Cholesky density/sampler against per-sample
    NumPy linear algebra, and the channel-major vs feature-last agreement."""
    from scipy.stats import multivariate_normal

    from psvo_tpu import networks
    from psvo_tpu.distributions import mvn_tril_log_prob_cm, mvn_tril_sample_cm

    d, k, b = 3, 8, 2
    key = jax.random.key(3)
    params = networks.init_mlp_head(
        key, d, d, (16,), cov_type="tril_head", sigma_init=0.8
    )
    # make the heads STRONGLY state-dependent
    params["tril_diag_head"] = (params["tril_diag_head"][0] * 50, params["tril_diag_head"][1])
    params["tril_off_head"] = (params["tril_off_head"][0] * 50, params["tril_off_head"][1])

    x_cm = jax.random.normal(jax.random.key(4), (b, d, k))
    y_cm = jax.random.normal(jax.random.key(5), (b, d, k))
    mean, diag, off = networks.mlp_mean_tril_cm(params, x_cm, sigma_min=1e-3)
    got = np.asarray(mvn_tril_log_prob_cm(y_cm, mean, diag, off))

    # feature-last assembly on the same points
    x_fl = np.moveaxis(np.asarray(x_cm), -1, -2)  # [B, K, D]
    mean_fl, chol_fl = networks.mlp_mean_tril(params, jnp.asarray(x_fl), sigma_min=1e-3)
    mean_fl, chol_fl = np.asarray(mean_fl), np.asarray(chol_fl)
    np.testing.assert_allclose(
        np.moveaxis(np.asarray(mean), -1, -2), mean_fl, rtol=1e-5, atol=1e-5
    )
    # chol varies with the state (the point of the head)
    assert np.abs(np.diff(chol_fl, axis=1)).max() > 1e-3

    y_fl = np.moveaxis(np.asarray(y_cm), -1, -2)
    want = np.empty((b, k))
    for i in range(b):
        for j in range(k):
            cov = chol_fl[i, j] @ chol_fl[i, j].T
            want[i, j] = multivariate_normal(mean_fl[i, j], cov).logpdf(y_fl[i, j])
    np.testing.assert_allclose(got, want, rtol=1e-4, atol=1e-4)

    # reparameterized draw: x = mean + L eps, per particle
    eps_cm = jax.random.normal(jax.random.key(6), (b, d, k))
    draw = np.asarray(mvn_tril_sample_cm(eps_cm, mean, diag, off))
    eps_fl = np.moveaxis(np.asarray(eps_cm), -1, -2)
    want_draw = mean_fl + np.einsum("bkde,bke->bkd", chol_fl, eps_fl)
    np.testing.assert_allclose(
        np.moveaxis(draw, -1, -2), want_draw, rtol=1e-5, atol=1e-5
    )


def test_trilhead_trains():
    """FHN with a state-dependent emission Cholesky head: the pipeline trains
    (finite, improving ELBO) through the cm tril_head density path."""
    cfg = Config(
        name="th_train",
        data=DataConfig(datatype="fhn", dx=2, dy=2, t_steps=12, n_train=32, n_test=8),
        smc=SMCConfig(objective="fivo", n_particles=16),
        train=TrainConfig(batch_size=16, n_steps=60, eval_every=30, lr=3e-3),
    ).with_nets(g=NetConfig(cov_type="tril_head", sigma_init=0.7))
    ssm, params = init_ssm(cfg, jax.random.key(0))
    ds = generate_dataset(cfg.data, 0)
    trainer = Trainer(cfg, ssm, params)
    hist = trainer.run(ds.obs_train, ds.obs_test)
    assert np.isfinite(hist[-1]["test_elbo"])
    assert hist[-1]["train_elbo"] > hist[0]["train_elbo"] - 1e-6


def test_trilhead_pairwise_matches_direct_density():
    """The D²-precision-contraction pairwise form (state-dependent Cholesky)
    equals the direct full-cov density evaluated pairwise per support point."""
    from psvo_tpu import networks
    from psvo_tpu.distributions import mvn_full_log_prob
    from psvo_tpu.objectives import _pairwise_transition_logp

    cfg = Config(
        name="pwh",
        data=DataConfig(datatype="fhn", dx=3, dy=3, t_steps=4),
        smc=SMCConfig(objective="psvo", n_particles=16),
    ).with_nets(f=NetConfig(cov_type="tril_head", hidden=(8,), sigma_init=0.7))
    ssm, params = init_ssm(cfg, jax.random.key(0))
    # strongly state-dependent factors
    params["f"]["tril_diag_head"] = (
        params["f"]["tril_diag_head"][0] * 30, params["f"]["tril_diag_head"][1]
    )
    params["f"]["tril_off_head"] = (
        params["f"]["tril_off_head"][0] * 30, params["f"]["tril_off_head"][1]
    )
    xs = jax.random.normal(jax.random.key(1), (2, 3, 16))  # [B, D, K]
    xq = jax.random.normal(jax.random.key(2), (2, 5, 3))  # [B, M, D]
    got = np.asarray(_pairwise_transition_logp(ssm, params, xs, xq))
    mean_fl, chol_fl = networks.mlp_mean_tril(
        params["f"], jnp.swapaxes(xs, -1, -2), sigma_min=ssm.nets["f"].sigma_min
    )  # [B, K, D], [B, K, D, D]
    want = np.asarray(
        mvn_full_log_prob(xq[:, :, None, :], mean_fl[:, None, :, :], chol_fl[:, None])
    )
    np.testing.assert_allclose(got, want, rtol=2e-4, atol=2e-4)


def test_trilhead_psvo_trains():
    """PSVO with a state-dependent transition Cholesky: the FFBSi backward
    runs through the precision-contraction pairwise path and trains."""
    cfg = Config(
        name="th_psvo",
        data=DataConfig(datatype="fhn", dx=2, dy=2, t_steps=10, n_train=16, n_test=8),
        smc=SMCConfig(objective="psvo", n_particles=16, n_smoothing_particles=4),
        train=TrainConfig(batch_size=8, n_steps=30, eval_every=15, lr=3e-3),
    ).with_nets(f=NetConfig(cov_type="tril_head", sigma_init=0.7))
    ssm, params = init_ssm(cfg, jax.random.key(0))
    ds = generate_dataset(cfg.data, 0)
    trainer = Trainer(cfg, ssm, params)
    hist = trainer.run(ds.obs_train, ds.obs_test)
    assert np.isfinite(hist[-1]["test_elbo"])


def test_invalid_mode_combinations_rejected():
    base = Config(
        name="bad",
        data=DataConfig(datatype="fhn", dx=2, dy=2, t_steps=4),
        smc=SMCConfig(objective="fivo", n_particles=8),
    )
    from psvo_tpu.models.ssm import SSM

    with pytest.raises(ValueError):  # tril proposals unsupported
        SSM(base.with_nets(q1=NetConfig(cov_type="tril")))
    with pytest.raises(ValueError):  # tril_head proposals unsupported
        SSM(base.with_nets(q2=NetConfig(cov_type="tril_head")))
    with pytest.raises(ValueError):  # known dynamics: diagonal noise only
        SSM(
            dataclasses.replace(
                base.with_nets(f=NetConfig(cov_type="tril")),
                smc=dataclasses.replace(base.smc, transition="known"),
            )
        )
