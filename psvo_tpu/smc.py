"""Forward particle filter as a single `lax.scan` over time.

Covers the reference's `SMC/SMC_base.py` (`get_log_ZSMC`, resample,
log-normalize helpers — SURVEY.md §2-A/§3.2, unverified paths): per step,
(optionally) resample ancestors, propose K particles from the (fused)
proposal, accumulate incremental log-weights `log f + log g − log q` and the
normalizing-constant estimate.

Shape (the reference builds a TF1 static graph; here the whole filter is
one traced scan):

- time   -> `lax.scan` carry (inherently sequential; SURVEY.md §2-B)
- batch  -> leading tensor axis [B], shardable over Mesh axis "data"
- K      -> the LAST tensor axis, shardable over Mesh axis "particle".
  Particle tensors are channel-major [B, Dx, K], so the tiny state dim is
  never the minor (contiguous) axis of a particle tensor.
- the only data-dependent op is the resampling gather
  (`psvo_tpu.ops.resampling`), which stays on-device.

Unified logZ accumulator (handles IWAE / FIVO / ESS-adaptive uniformly):
carry unnormalized cumulative log-weights `logw`; each step adds the
incremental weight α_t and accumulates

    logZ += logsumexp_k(logw + α_t) − logsumexp_k(logw)

With per-step resampling `logw` resets to 0 so each term is the FIVO
increment `logsumexp(α_t) − log K`; with no resampling the sum telescopes to
the IWAE bound `logsumexp_k(Σ_t α_t) − log K`. Both limits are unit-tested
against a NumPy reference (tests/reference_numpy) and the Kalman oracle.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Optional

import jax
import jax.numpy as jnp
from jax.ad_checkpoint import checkpoint_name as _checkpoint_name

from psvo_tpu.config import SMCConfig
from psvo_tpu.distributions import (
    effective_sample_size,
    log_normalize,
    mvn_diag_log_prob_cm,
    mvn_tril_sample_cm,
)
from psvo_tpu.models.ssm import SSM
from psvo_tpu.ops import resampling
from psvo_tpu.parallel.context import constrain

# logsumexp over the particle axis. Under a mesh GSPMD partitions this
# directly (the shard_map resampling island has its own psum-based
# normalizer — ops/sharded_resampling.py).
def _lse(logw: jax.Array) -> jax.Array:
    return jax.scipy.special.logsumexp(logw, axis=-1)


@jax.tree_util.register_dataclass
@dataclass
class FilterResult:
    """Everything downstream objectives need from one forward pass.

    xs/logws are the per-step filtering particles and (cumulative-since-
    resample) log-weights cached time-major for the smoothing objectives
    (SVO/PSVO reverse scan); None when caching is off (IWAE/FIVO don't pay
    the HBM).
    """

    log_z: jax.Array  # [B] final normalizing-constant estimate
    increments: jax.Array  # [T, B] per-step logZ increments ℓ_t
    ess: jax.Array  # [T, B] effective sample size before resampling
    x_last: jax.Array  # [B, Dx, K] (channel-major: K last)
    logw_last: jax.Array  # [B, K]
    xs: Optional[jax.Array] = None  # [T, B, Dx, K]
    logws: Optional[jax.Array] = None  # [T, B, K]
    # per-step posterior filtering means — O(T·B·Dx), always emitted so that
    # evaluation (k-step R², plots) never needs the full particle cache
    filtered_means: Optional[jax.Array] = None  # [T, B, Dx]
    # zero-valued-gradient carrier for the resampling score-function term
    # (use_stop_gradient=False, the full FIVO gradient); None when disabled.
    score_surrogate: Optional[jax.Array] = None  # [B]


@jax.named_scope("smc_init_t0")
def _init_t0(ssm: SSM, params, eps0, y0, enc0):
    """t=0: propose x0 ~ q0(·|y0) (reparameterized with eps0 [B, Dx, K]),
    weight against the learned prior: α0 = log p(x0) + log g(y0|x0) − log q0(x0)."""
    mean0, scale0 = ssm.propose_initial(params, enc0)  # [B, Dx]
    x0 = constrain(mean0[:, :, None] + scale0[:, :, None] * eps0)  # [B, Dx, K]
    log_g0 = ssm.emission_log_prob_cm(params, x0, y0)
    if ssm.use_bootstrap:
        alpha0 = log_g0  # proposal == prior: densities cancel
    else:
        alpha0 = (
            ssm.prior_log_prob_cm(params, x0)
            + log_g0
            - mvn_diag_log_prob_cm(x0, mean0[:, :, None], scale0[:, :, None])
        )
    return x0, alpha0


def _make_step_body(ssm: SSM, params, cfg: SMCConfig):
    """One filtering step t: (maybe) resample → propose → weight.

    carry (x [B,Dx,K], logw [B,K]); inputs
    (y_t, q2 mean/scale, u_ctrl, eps_t, u_t); emits (x_new, logw_new, ell, ess).
    """
    resample_on = cfg.resampling != "none"
    # Trace-time dispatch: under an active mesh the resample runs as a
    # shard_map island (hierarchical inverse-CDF + ppermute ring) so GSPMD
    # never sees the data-dependent gather — it would otherwise all-gather
    # the full [B, D, K] particle tensor every step (HLO-verified; see
    # ops/sharded_resampling.py).
    from psvo_tpu.parallel.context import get_mesh

    mesh = get_mesh()

    def _resample(u_t, logw, x):
        if mesh is not None:
            from psvo_tpu.ops.sharded_resampling import sharded_maybe_resample

            return sharded_maybe_resample(
                mesh,
                u_t,
                logw,
                x,
                method=cfg.resampling,
                ess_threshold=cfg.ess_threshold,
            )
        return resampling.maybe_resample(
            u_t,
            logw,
            x,
            method=cfg.resampling,
            ess_threshold=cfg.ess_threshold,
        )

    # q2 is precomputed for ALL steps outside the scan (ssm.q2_mean_scale);
    # the body receives its per-step (mean, scale) instead of the raw
    # encoder input. Zero-width placeholders when q2 is unused.
    use_q2 = cfg.use_2q and not cfg.use_bootstrap

    def body(carry, inputs):
        x, logw = carry
        # [B, Dy], 2x [B, Dx], [B, Di], [B, Dx, K], [B, K]
        y_t, q2m_t, q2s_t, u_ctrl, eps_t, u_t = inputs
        q2_ms = (q2m_t, q2s_t) if use_q2 else None

        score = jnp.zeros(logw.shape[0])
        if resample_on:
            logw_pre = logw
            with jax.named_scope("resample"):
                x, logw, did, ess, idx = _resample(u_t, logw, x)
            if not cfg.use_stop_gradient:
                # Score-function term for the resampling distribution (the
                # full FIVO gradient, Maddison et al. 2017): the categorical
                # log-prob of the chosen ancestors, Σ_k log Ŵ_t[a_k],
                # differentiable through the normalized weights. Zero where
                # the ESS test skipped resampling.
                logw_norm, _ = log_normalize(logw_pre, axis=-1)
                picked = jnp.take_along_axis(logw_norm, idx, axis=-1)  # [B, K]
                score = jnp.where(did, jnp.sum(picked, axis=-1), 0.0)
            # Named remat residual: the rematerialized backward would
            # otherwise re-run the whole resample just to rebuild this
            # tensor; saving it costs the same memory as the scan carry.
            x = _checkpoint_name(x, "resampled_x")
        else:
            ess = effective_sample_size(logw, axis=-1)

        # Propose K new particles; α_t = log f + log g − log q (bootstrap:
        # f == q so the transition/proposal densities cancel).
        if ssm.f_tril and ssm.use_bootstrap:
            # bootstrap PF with full-covariance transition noise: correlated
            # reparameterized draw x = mean + L @ eps (constant or per-state L)
            if ssm.f_tril_head:
                mean_f, diag_f, off_f = ssm.transition_tril_cm(params, x, u_ctrl)
                x_new = constrain(
                    mvn_tril_sample_cm(eps_t, mean_f, diag_f, off_f)
                )
            else:
                mean_f, chol_f = ssm.transition_full_cm(params, x, u_ctrl)
                x_new = constrain(
                    mean_f + jnp.einsum("de,...ek->...dk", chol_f, eps_t)
                )
            alpha = ssm.emission_log_prob_cm(params, x_new, y_t)
        elif ssm.f_tril:
            mean_q, scale_q = ssm.propose_cm(params, x, y_t, u_ctrl, q2_ms)
            x_new = constrain(mean_q + scale_q * eps_t)
            alpha = (
                ssm.transition_log_prob_cm(params, x, x_new, u_ctrl)
                + ssm.emission_log_prob_cm(params, x_new, y_t)
                - mvn_diag_log_prob_cm(x_new, mean_q, scale_q)
            )
        else:
            # diagonal fast path: q1 and f evaluate as one stacked MLP
            # (ssm.step_heads_cm), so α_t reuses the transition parameters
            # instead of re-running the f network.
            mean_q, scale_q, mean_f, scale_f = ssm.step_heads_cm(
                params, x, y_t, u_ctrl, q2_ms
            )
            x_new = constrain(mean_q + scale_q * eps_t)  # [B, Dx, K]
            log_g = ssm.emission_log_prob_cm(params, x_new, y_t)
            if ssm.use_bootstrap:
                alpha = log_g
            else:
                alpha = (
                    mvn_diag_log_prob_cm(x_new, mean_f, scale_f)
                    + log_g
                    - mvn_diag_log_prob_cm(x_new, mean_q, scale_q)
                )

        logw_new = constrain(logw + alpha)
        ell = _lse(logw_new) - _lse(logw)  # [B] logZ increment

        w_norm = jax.nn.softmax(logw_new, axis=-1)
        fmean = jnp.einsum("bk,bdk->bd", w_norm, x_new)  # [B, Dx]

        out = (x_new, logw_new, ell, ess, score, fmean)
        return (x_new, logw_new), out

    return body


def _segment_randomness(ssm: SSM, cfg: SMCConfig, k_prop_seg, k_res_seg, length, batch, k):
    """Per-segment bulk RNG (proposal normals + resampling positions)."""
    eps = jax.random.normal(k_prop_seg, (length, batch, ssm.dx, k))
    if cfg.resampling != "none":
        u = resampling.bulk_positions(k_res_seg, length, batch, k, cfg.resampling)
    else:
        u = jnp.zeros((length, batch, 1))
    return eps, u


def _controls_tm(controls, batch, t_steps, di):
    """Time-major [T, B, Di] control inputs (zeros when absent; Di may be 0)."""
    if controls is not None:
        return jnp.swapaxes(controls, 0, 1)
    return jnp.zeros((t_steps, batch, di), jnp.float32)


def _q2_tm(ssm: SSM, params, cfg: SMCConfig, enc_tm):
    """Precompute the encoder proposal q2 over all T in ONE batched call.

    Inside the latency-bound scan the per-step q2 MLP on [B, E] was pure
    kernel-launch overhead. Returns zero-width placeholders when q2 is
    unused (bootstrap / use_2q=False) so the scan input structure is static.
    """
    if cfg.use_2q and not cfg.use_bootstrap:
        return ssm.q2_mean_scale(params, enc_tm)  # 2 x [T, B, Dx]
    t_steps, batch = enc_tm.shape[0], enc_tm.shape[1]
    z = jnp.zeros((t_steps, batch, 0), jnp.float32)
    return z, z


def forward_filter(
    ssm: SSM,
    params,
    key: jax.Array,
    ys: jax.Array,
    cfg: SMCConfig,
    *,
    cache: bool = False,
    encoder_inputs: Optional[jax.Array] = None,
    controls: Optional[jax.Array] = None,
    noise: Optional[tuple] = None,
) -> FilterResult:
    """Run the forward SMC pass on observations ys [B, T, Dy].

    encoder_inputs optionally replaces what the encoder proposal q2 sees per
    step (the reference's `q_uses_true_X` debug flag feeds true latents).
    controls [B, T, Di] are exogenous inputs (reference `Di`): x_t ~
    f(· | x_{t-1}, u_t), so step t consumes controls[:, t].
    noise is a testing/diagnostic hook: a (eps0 [B,Dx,K], eps_scan
    [T-1,B,Dx,K], u_scan [T-1,B,K]) tuple replacing the key-derived draws —
    the SURVEY §4.3 gradient-enumeration test conditions on fixed noise and
    enumerates the resampling outcomes through u_scan, and the GPU-vs-CPU
    comparison feeds both backends the same draws through it.
    """
    batch, t_steps, _ = ys.shape
    k = cfg.n_particles
    resample_on = cfg.resampling != "none"

    ys_tm = jnp.swapaxes(ys, 0, 1)  # [T, B, Dy] time-major for scan
    enc_tm = (
        jnp.swapaxes(encoder_inputs, 0, 1) if encoder_inputs is not None else ys_tm
    )
    ctrl_tm = _controls_tm(controls, batch, t_steps, ssm.di)
    q2m_tm, q2s_tm = _q2_tm(ssm, params, cfg, enc_tm)

    # ---- Bulk RNG: one call per stream for ALL T steps, outside the scan,
    # so the scan body launches no per-step key splits or sample chains.
    if noise is not None:
        eps0, eps_scan, u_scan = noise
    else:
        k0, k_prop, k_res = jax.random.split(key, 3)
        eps0 = jax.random.normal(k0, (batch, ssm.dx, k))
        eps_scan = jax.random.normal(k_prop, (t_steps - 1, batch, ssm.dx, k))
        if resample_on:
            # [T-1, B, K] quantile positions, sorted along K, built in one
            # shot instead of per-step position math inside the scan.
            u_scan = resampling.bulk_positions(
                k_res, t_steps - 1, batch, k, cfg.resampling
            )
        else:
            u_scan = jnp.zeros((t_steps - 1, batch, 1))  # unused placeholder

    # ---- t = 0: propose from q0(x_0 | y_0), weight against the learned prior.
    x0, alpha0 = _init_t0(ssm, params, eps0, ys_tm[0], enc_tm[0])
    logw = alpha0  # [B, K]
    ell0 = _lse(logw) - jnp.log(float(k))  # [B]

    # ---- t = 1 .. T-1 scan
    body = _make_step_body(ssm, params, cfg)

    carry0 = (x0, logw)
    scan_body = (
        jax.checkpoint(
            body,
            policy=jax.checkpoint_policies.save_only_these_names(
                "resampled_x", "resample_idx"
            ),
        )
        if cfg.remat
        else body
    )
    (x_last, logw_last), (
        xs_scan,
        logws_scan,
        ells,
        esss,
        scores,
        fmeans,
    ) = jax.lax.scan(
        scan_body,
        carry0,
        (ys_tm[1:], q2m_tm[1:], q2s_tm[1:], ctrl_tm[1:], eps_scan, u_scan),
    )

    increments = jnp.concatenate([ell0[None], ells], axis=0)  # [T, B]
    ess_all = jnp.concatenate(
        [effective_sample_size(alpha0, axis=-1)[None], esss], axis=0
    )
    log_z = jnp.sum(increments, axis=0)

    xs = logws = None
    if cache:
        xs = jnp.concatenate([x0[None], xs_scan], axis=0)  # [T, B, Dx, K]
        logws = jnp.concatenate([alpha0[None], logws_scan], axis=0)

    fmean0 = jnp.einsum("bk,bdk->bd", jax.nn.softmax(alpha0, axis=-1), x0)
    return FilterResult(
        log_z=log_z,
        increments=increments,
        ess=ess_all,
        x_last=x_last,
        logw_last=logw_last,
        xs=xs,
        logws=logws,
        filtered_means=jnp.concatenate([fmean0[None], fmeans], axis=0),
        score_surrogate=(
            None if cfg.use_stop_gradient else _score_surrogate(ells, scores)
        ),
    )


def _score_surrogate(ells: jax.Array, scores: jax.Array) -> jax.Array:
    """Σ_t stopgrad(Σ_{s>=t} ℓ_s) · score_t — the REINFORCE term for the
    resampling distribution in the full FIVO gradient (Maddison et al. 2017):
    the return-to-go from step t (the resampling at t influences every later
    increment including its own step's) weights the categorical log-prob of
    the chosen ancestors. Value is meaningless; callers add
    (surrogate − stopgrad(surrogate)) to the loss so only the gradient acts."""
    future = jnp.cumsum(ells[::-1], axis=0)[::-1]  # [T-1, B] inclusive tail-sum
    return jnp.sum(jax.lax.stop_gradient(future) * scores, axis=0)


# ---------------------------------------------------------------------------
# Segmented filtering: the long-sequence story (SURVEY.md §5).
#
# PSVO's FFBSi needs the whole forward history (xs, logws) — O(T·B·K·Dx) HBM.
# For long T, cache only the scan carries at segment boundaries and recompute
# each segment's interior during the backward sweep (same keys → bit-identical
# particles). Memory: O((T/L)·B·K·Dx) persistent + O(L·B·K·Dx) transient.
# ---------------------------------------------------------------------------


@jax.tree_util.register_dataclass
@dataclass
class SegmentedCache:
    """Everything needed to reproduce any forward segment exactly."""

    x0: jax.Array  # [B, Dx, K] initial particles (channel-major)
    alpha0: jax.Array  # [B, K] t=0 log-weights
    seg_x: jax.Array  # [S, B, Dx, K] carry entering each segment
    seg_logw: jax.Array  # [S, B, K]
    k_prop_segs: jax.Array  # [S] keys for per-segment proposal noise
    k_res_segs: jax.Array  # [S] keys for per-segment resampling positions


def forward_filter_segmented(
    ssm: SSM,
    params,
    key: jax.Array,
    ys: jax.Array,
    cfg: SMCConfig,
    n_segments: int,
    *,
    encoder_inputs: Optional[jax.Array] = None,
    controls: Optional[jax.Array] = None,
) -> tuple[FilterResult, SegmentedCache]:
    """Forward pass that stores segment-boundary carries instead of the full
    per-step cache. Requires (T-1) % n_segments == 0."""
    batch, t_steps, _ = ys.shape
    k = cfg.n_particles
    if (t_steps - 1) % n_segments:
        raise ValueError(f"T-1={t_steps-1} not divisible by {n_segments} segments")
    seg_len = (t_steps - 1) // n_segments

    ys_tm = jnp.swapaxes(ys, 0, 1)
    enc_tm = (
        jnp.swapaxes(encoder_inputs, 0, 1) if encoder_inputs is not None else ys_tm
    )
    ctrl_tm = _controls_tm(controls, batch, t_steps, ssm.di)

    k0, k_prop, k_res = jax.random.split(key, 3)
    eps0 = jax.random.normal(k0, (batch, ssm.dx, k))
    k_prop_segs = jax.random.split(k_prop, n_segments)
    k_res_segs = jax.random.split(k_res, n_segments)

    x0, alpha0 = _init_t0(ssm, params, eps0, ys_tm[0], enc_tm[0])
    ell0 = _lse(alpha0) - jnp.log(float(k))

    body = _make_step_body(ssm, params, cfg)
    inner_body = (
        jax.checkpoint(
            body,
            policy=jax.checkpoint_policies.save_only_these_names(
                "resampled_x", "resample_idx"
            ),
        )
        if cfg.remat
        else body
    )

    # [S, L, B, ...] views of the per-step inputs
    q2m_tm, q2s_tm = _q2_tm(ssm, params, cfg, enc_tm)
    ys_seg = ys_tm[1:].reshape(n_segments, seg_len, batch, -1)
    q2m_seg = q2m_tm[1:].reshape(n_segments, seg_len, batch, -1)
    q2s_seg = q2s_tm[1:].reshape(n_segments, seg_len, batch, -1)
    ctrl_seg = ctrl_tm[1:].reshape(n_segments, seg_len, batch, ssm.di)

    def outer(carry, inputs):
        x, logw = carry
        ys_s, q2m_s, q2s_s, ctrl_s, kp, kr = inputs
        eps, u = _segment_randomness(ssm, cfg, kp, kr, seg_len, batch, k)
        (x_out, logw_out), (_, _, ells, esss, scores, fmeans) = jax.lax.scan(
            inner_body, (x, logw), (ys_s, q2m_s, q2s_s, ctrl_s, eps, u)
        )
        return (x_out, logw_out), (x, logw, ells, esss, scores, fmeans)

    (x_last, logw_last), (seg_x, seg_logw, ells, esss, scores, fmeans) = jax.lax.scan(
        outer,
        (x0, alpha0),
        (ys_seg, q2m_seg, q2s_seg, ctrl_seg, k_prop_segs, k_res_segs),
    )

    increments = jnp.concatenate([ell0[None], ells.reshape(-1, batch)], axis=0)
    ess_all = jnp.concatenate(
        [effective_sample_size(alpha0, axis=-1)[None], esss.reshape(-1, batch)],
        axis=0,
    )
    fmean0 = jnp.einsum("bk,bdk->bd", jax.nn.softmax(alpha0, axis=-1), x0)
    result = FilterResult(
        log_z=jnp.sum(increments, axis=0),
        increments=increments,
        ess=ess_all,
        x_last=x_last,
        logw_last=logw_last,
        filtered_means=jnp.concatenate(
            [fmean0[None], fmeans.reshape(-1, *fmeans.shape[2:])], axis=0
        ),
        score_surrogate=(
            None
            if cfg.use_stop_gradient
            else _score_surrogate(
                ells.reshape(-1, batch), scores.reshape(-1, batch)
            )
        ),
    )
    cache = SegmentedCache(
        x0=x0,
        alpha0=alpha0,
        seg_x=seg_x,
        seg_logw=seg_logw,
        k_prop_segs=k_prop_segs,
        k_res_segs=k_res_segs,
    )
    return result, cache


def recompute_segment(
    ssm: SSM,
    params,
    cfg: SMCConfig,
    cache: SegmentedCache,
    s: int,
    ys_seg_s: jax.Array,
    enc_seg_s: jax.Array,
    ctrl_seg_s: jax.Array,
) -> tuple[jax.Array, jax.Array]:
    """Re-run forward segment `s` (static index) from its stored carry.

    Returns (xs [L,B,Dx,K], logws [L,B,K]) — the cache entries for
    t in [1 + s·L, s·L + L], bit-identical to the original forward pass
    (same keys, same scan body)."""
    seg_len, batch = ys_seg_s.shape[0], ys_seg_s.shape[1]
    k = cfg.n_particles
    eps, u = _segment_randomness(
        ssm, cfg, cache.k_prop_segs[s], cache.k_res_segs[s], seg_len, batch, k
    )
    # per-segment q2 recompute is bit-identical to the full-T hoisted call
    # (row-wise matmul results don't depend on the batching dims)
    q2m_s, q2s_s = _q2_tm(ssm, params, cfg, enc_seg_s)
    body = _make_step_body(ssm, params, cfg)
    if cfg.remat:
        body = jax.checkpoint(
            body,
            policy=jax.checkpoint_policies.save_only_these_names(
                "resampled_x", "resample_idx"
            ),
        )
    _, (xs, logws, _, _, _, _) = jax.lax.scan(
        body,
        (cache.seg_x[s], cache.seg_logw[s]),
        (ys_seg_s, q2m_s, q2s_s, ctrl_seg_s, eps, u),
    )
    return xs, logws
