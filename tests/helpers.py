"""Shared test fixtures: an exactly-known linear-Gaussian SSM in psvo_tpu form."""

from __future__ import annotations

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np

from psvo_tpu.config import Config, DataConfig, NetConfig, SMCConfig
from psvo_tpu.models.ssm import SSM


def raw_from_scale(scale: float, sigma_min: float) -> float:
    """Invert scale = softplus(raw) + sigma_min."""
    return float(np.log(np.expm1(max(scale - sigma_min, 1e-8))))


SIGMA_MIN = 1e-4


def lgssm_setup(
    *,
    a: np.ndarray,
    c: np.ndarray,
    q_scale: float,
    r_scale: float,
    mu0: np.ndarray,
    s0_scale: float,
    objective: str = "fivo",
    n_particles: int = 1024,
    n_smoothing: int = 16,
    resampling: str = "systematic",
    t_steps: int = 20,
):
    """Build (cfg, ssm, params) whose transition/emission/prior EXACTLY equal
    the LGSSM (A, C, qI, rI, mu0, s0I), run in bootstrap mode so the proposal
    is the true transition — a bootstrap particle filter with known logZ."""
    dx, dy = a.shape[0], c.shape[0]
    lin = NetConfig(hidden=(), cov_type="const", sigma_init=1.0, sigma_min=SIGMA_MIN)
    cfg = Config(
        name="lgssm_oracle",
        data=DataConfig(datatype="lgssm", dx=dx, dy=dy, t_steps=t_steps),
        smc=SMCConfig(
            objective=objective,
            n_particles=n_particles,
            n_smoothing_particles=n_smoothing,
            resampling=resampling,
            use_bootstrap=True,
        ),
    ).with_nets(q0=lin, q1=lin, q2=lin, f=lin, g=lin, qb=lin)

    ssm = SSM(cfg)
    params = ssm.init(jax.random.key(0))

    params["f"]["mean"] = (jnp.asarray(a.T, jnp.float32), jnp.zeros((dx,)))
    params["f"]["raw_scale"] = jnp.full((dx,), raw_from_scale(q_scale, SIGMA_MIN))
    params["g"]["mean"] = (jnp.asarray(c.T, jnp.float32), jnp.zeros((dy,)))
    params["g"]["raw_scale"] = jnp.full((dy,), raw_from_scale(r_scale, SIGMA_MIN))
    params["prior"]["mean"] = jnp.asarray(mu0, jnp.float32)
    params["prior"]["raw_scale"] = jnp.full((dx,), raw_from_scale(s0_scale, 1e-3))
    return cfg, ssm, params


def simulate_lgssm(rng, a, c, q_scale, r_scale, mu0, s0_scale, t_steps, batch):
    dx, dy = a.shape[0], c.shape[0]
    xs = np.zeros((batch, t_steps, dx), np.float32)
    ys = np.zeros((batch, t_steps, dy), np.float32)
    x = mu0 + s0_scale * rng.standard_normal((batch, dx))
    for t in range(t_steps):
        if t > 0:
            x = x @ a.T + q_scale * rng.standard_normal((batch, dx))
        xs[:, t] = x
        ys[:, t] = x @ c.T + r_scale * rng.standard_normal((batch, dy))
    return xs, ys


def lgssm_full_setup(
    *,
    a: np.ndarray,
    c: np.ndarray,
    q_chol: np.ndarray,
    r_chol: np.ndarray,
    mu0: np.ndarray,
    s0_scale: float,
    objective: str = "fivo",
    n_particles: int = 2048,
    n_smoothing: int = 16,
    t_steps: int = 20,
):
    """Full-covariance LGSSM oracle: cov_type='tril' transition/emission set
    EXACTLY to (A, C, Lq, Lr, mu0, s0I); bootstrap mode so the proposal is the
    true correlated-noise transition."""
    dx, dy = a.shape[0], c.shape[0]
    lin = NetConfig(hidden=(), cov_type="const", sigma_init=1.0, sigma_min=SIGMA_MIN)
    tril = NetConfig(hidden=(), cov_type="tril", sigma_init=1.0, sigma_min=SIGMA_MIN)
    cfg = Config(
        name="lgssm_tril_oracle",
        data=DataConfig(datatype="lgssm", dx=dx, dy=dy, t_steps=t_steps),
        smc=SMCConfig(
            objective=objective,
            n_particles=n_particles,
            n_smoothing_particles=n_smoothing,
            resampling="systematic",
            use_bootstrap=True,
        ),
    ).with_nets(q0=lin, q1=lin, q2=lin, f=tril, g=tril, qb=lin)

    ssm = SSM(cfg)
    params = ssm.init(jax.random.key(0))

    def set_tril(head, mat, chol):
        head["mean"] = (jnp.asarray(mat.T, jnp.float32), jnp.zeros((mat.shape[0],)))
        d = chol.shape[0]
        head["raw_tril"]["diag"] = jnp.asarray(
            [raw_from_scale(float(chol[i, i]), SIGMA_MIN) for i in range(d)],
            jnp.float32,
        )
        rows, cols = np.tril_indices(d, k=-1)
        head["raw_tril"]["off"] = jnp.asarray(chol[rows, cols], jnp.float32)

    set_tril(params["f"], a, q_chol)
    set_tril(params["g"], c, r_chol)
    params["prior"]["mean"] = jnp.asarray(mu0, jnp.float32)
    params["prior"]["raw_scale"] = jnp.full((dx,), raw_from_scale(s0_scale, 1e-3))
    return cfg, ssm, params


def simulate_lgssm_full(rng, a, c, q_chol, r_chol, mu0, s0_scale, t_steps, batch):
    """LGSSM with CORRELATED process/observation noise (Q = Lq Lqᵀ etc.)."""
    dx, dy = a.shape[0], c.shape[0]
    xs = np.zeros((batch, t_steps, dx), np.float32)
    ys = np.zeros((batch, t_steps, dy), np.float32)
    x = mu0 + s0_scale * rng.standard_normal((batch, dx))
    for t in range(t_steps):
        if t > 0:
            x = x @ a.T + rng.standard_normal((batch, dx)) @ q_chol.T
        xs[:, t] = x
        ys[:, t] = x @ c.T + rng.standard_normal((batch, dy)) @ r_chol.T
    return xs, ys


def default_lgssm():
    theta = 0.4
    a = 0.85 * np.array(
        [[np.cos(theta), -np.sin(theta)], [np.sin(theta), np.cos(theta)]], np.float32
    )
    c = np.eye(2, dtype=np.float32)
    return dict(a=a, c=c, q_scale=0.4, r_scale=0.5, mu0=np.zeros(2, np.float32), s0_scale=1.0)


def replace_smc(cfg: Config, **kw) -> Config:
    return dataclasses.replace(cfg, smc=dataclasses.replace(cfg.smc, **kw))
