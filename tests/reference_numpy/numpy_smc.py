"""Trusted NumPy reimplementation of the reference's forward SMC objective.

Two roles (SURVEY.md §4.2):
1. Numerics cross-check — a slow, obviously-correct implementation of the
   same math as `psvo_tpu.smc.forward_filter` (resample → propose → weight,
   FIVO accumulation), statistically compared against the JAX path.
2. The "reference CPU" timing stand-in for the 50× north-star comparison
   (BASELINE.json): the reference repo is a single-process CPU-bound Python
   loop over T; this NumPy loop is the faithful performance model of it, and
   `bench.py` measures it as `vs_baseline`'s denominator.

It consumes the *same* parameter pytree as the JAX SSM (converted to NumPy)
so both paths evaluate identical models.
"""

from __future__ import annotations

from dataclasses import dataclass

import numpy as np


def _softplus(x):
    return np.logaddexp(x, 0.0)


def _mlp_mean_scale(net, x, activation="relu", sigma_min=1e-3):
    act = {"relu": lambda h: np.maximum(h, 0.0), "tanh": np.tanh}[activation]
    h = x
    for w, b in net["layers"]:
        h = act(h @ w + b)
    wm, bm = net["mean"]
    mean = h @ wm + bm
    if "raw_scale" in net:
        scale = np.broadcast_to(_softplus(net["raw_scale"]) + sigma_min, mean.shape)
    else:
        ws, bs = net["scale_head"]
        scale = _softplus(h @ ws + bs) + sigma_min
    return mean, scale


def _mvn_logpdf_diag(x, mean, scale):
    z = (x - mean) / scale
    return np.sum(-0.5 * z * z - np.log(scale) - 0.5 * np.log(2 * np.pi), axis=-1)


def _logsumexp(a, axis=-1):
    m = np.max(a, axis=axis, keepdims=True)
    return np.squeeze(m, axis) + np.log(np.sum(np.exp(a - m), axis=axis))


def _systematic_indices(rng, w, u0=None):
    """u0 [B, 1] in [0, 1): the shared offset; drawn from rng when None."""
    k = w.shape[-1]
    cumw = np.cumsum(w, axis=-1)
    if u0 is None:
        u0 = rng.uniform(size=(w.shape[0], 1))
    u = (np.arange(k) + u0) / k
    idx = np.zeros_like(u, dtype=np.int64)
    for b in range(w.shape[0]):
        idx[b] = np.searchsorted(cumw[b], u[b], side="right")
    return np.minimum(idx, k - 1)


@dataclass
class NumpySSMParams:
    """NumPy view of the psvo_tpu params pytree + static flags."""

    params: dict
    use_2q: bool = True
    use_bootstrap: bool = False
    activation: str = "relu"
    sigma_min: float = 1e-3

    @classmethod
    def from_jax(cls, params, ssm):
        import jax

        np_params = jax.tree_util.tree_map(lambda a: np.asarray(a), params)
        return cls(
            params=np_params,
            use_2q=ssm.use_2q,
            use_bootstrap=ssm.use_bootstrap,
            activation=ssm.nets["q1"].activation,
            sigma_min=ssm.nets["q1"].sigma_min,
        )


def numpy_forward_filter(
    model: NumpySSMParams, ys, k, seed=0, resampling="systematic",
    noise=None, controls=None,
):
    """Bootstrap/proposal SMC in plain NumPy. ys: [B, T, Dy]. Returns logZ [B].

    noise optionally replaces the seeded draws with the exact draws of
    `psvo_tpu.smc.forward_filter(..., noise=(eps0, eps_scan, u_scan))` in
    their channel-major layout — eps0 [B, Dx, K], eps_scan [T-1, B, Dx, K],
    u_scan [T-1, B, K] systematic positions — so the two filters can be
    compared draw for draw. controls [B, T, Di] feed the q1 and f heads as
    [x, u_t] (the JAX model's control input)."""
    rng = np.random.default_rng(seed)
    if noise is not None:
        eps0_n, eps_n, u_n = (np.asarray(a, np.float64) for a in noise)
        eps0_n = np.swapaxes(eps0_n, -1, -2)  # [B, K, Dx]
        eps_n = np.swapaxes(eps_n, -1, -2)  # [T-1, B, K, Dx]
    p = model.params
    batch, t_steps, _ = ys.shape
    dx = p["prior"]["mean"].shape[0]
    ms = lambda net, x: _mlp_mean_scale(net, x, model.activation, model.sigma_min)

    prior_mean = p["prior"]["mean"]
    prior_scale = _softplus(p["prior"]["raw_scale"]) + 1e-3

    # t = 0
    if model.use_bootstrap:
        mean0 = np.broadcast_to(prior_mean, (batch, 1, dx))
        scale0 = np.broadcast_to(prior_scale, (batch, 1, dx))
    else:
        m, s = ms(p["q0"], ys[:, 0])
        mean0, scale0 = m[:, None, :], s[:, None, :]
    x = mean0 + scale0 * (
        eps0_n if noise is not None else rng.standard_normal((batch, k, dx))
    )
    gm, gs = ms(p["g"], x)
    log_g = _mvn_logpdf_diag(ys[:, 0][:, None, :], gm, gs)
    if model.use_bootstrap:
        logw = log_g
    else:
        logw = (
            _mvn_logpdf_diag(x, prior_mean, prior_scale)
            + log_g
            - _mvn_logpdf_diag(x, mean0, scale0)
        )
    log_z = _logsumexp(logw) - np.log(k)

    for t in range(1, t_steps):
        if resampling != "none":
            w = np.exp(logw - _logsumexp(logw)[:, None])
            u0 = None if noise is None else u_n[t - 1][:, :1] * k
            idx = _systematic_indices(rng, w, u0)
            x = np.take_along_axis(x, idx[..., None], axis=1)
            logw = np.zeros_like(logw)

        x_in = x
        if controls is not None:
            u_t = np.broadcast_to(
                controls[:, t][:, None, :], (batch, k, controls.shape[-1])
            )
            x_in = np.concatenate([x, u_t], axis=-1)
        if model.use_bootstrap:
            mq, sq = ms(p["f"], x_in)
        else:
            m1, s1 = ms(p["q1"], x_in)
            if model.use_2q:
                m2, s2 = ms(p["q2"], ys[:, t])
                m2, s2 = m2[:, None, :], s2[:, None, :]
                prec = 1.0 / (s1 * s1) + 1.0 / (s2 * s2)
                var = 1.0 / prec
                mq = var * (m1 / (s1 * s1) + m2 / (s2 * s2))
                sq = np.sqrt(var)
            else:
                mq, sq = m1, s1
        x_new = mq + sq * (
            eps_n[t - 1] if noise is not None else rng.standard_normal(x.shape)
        )

        gm, gs = ms(p["g"], x_new)
        log_g = _mvn_logpdf_diag(ys[:, t][:, None, :], gm, gs)
        if model.use_bootstrap:
            alpha = log_g
        else:
            fm, fs = ms(p["f"], x_in)
            alpha = (
                _mvn_logpdf_diag(x_new, fm, fs)
                + log_g
                - _mvn_logpdf_diag(x_new, mq, sq)
            )
        logw_new = logw + alpha
        log_z = log_z + _logsumexp(logw_new) - _logsumexp(logw)
        logw = logw_new
        x = x_new

    return log_z
