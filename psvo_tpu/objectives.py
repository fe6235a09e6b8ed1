"""Variational SMC objectives: IWAE, FIVO/AESMC, SVO, PSVO.

Covers the reference's `SMC/{IWAE,AESMC,SVO,PSVO}.py` (SURVEY.md §2-A/§3.3,
unverified paths). All four share the forward filter (`psvo_tpu.smc`); the
smoothing objectives add a reverse-time `lax.scan` over the cached forward
particles/log-weights, exactly the north-star mapping (BASELINE.json).

Estimator definitions (the reference TF source was unreadable — SURVEY.md §0 —
so these are pinned to the published algorithms and validated against
exact Kalman/RTS oracles in tests/test_oracle_kalman.py):

- IWAE   log Ẑ = logsumexp_k(Σ_t α_t) − log K; no resampling; fully
         reparameterized (Burda et al.; SURVEY.md §2-A "IWAE").
- FIVO   per-step resampling; gradients take the standard biased FIVO form:
         reparameterized proposal draws + stop-gradient through ancestor
         selection (Maddison/Le/Naesseth 2017-18; SURVEY.md §3.2).
- SVO    smoothing with a *learned continuous backward proposal*
         q_b(x_t | x_{t+1}, y_t): draw M backward trajectories anchored on
         final-time filter particles and evaluate the IWAE-style bound

           L = E[ logsumexp_m( log p(x̃^m, y) − log q̃(x̃^m) ) − log M ]

         where q̃(x̃) = ρ_T(x̃_T) · Π_t q_b(x̃_t | x̃_{t+1}, y_t) and the
         final-time draw's density is the continuous filter surrogate
         ρ_T(x) = g(y_T|x) · p̂(x | y_{1:T-1}) / exp(ℓ_T) with the particle
         predictive mixture p̂(x|y_{1:T-1}) = Σ_j Ŵ_{T-1}^j f(x | X_{T-1}^j).
         Every factor has density units, so L → log p(y) on the LGSSM oracle
         as q_b approaches the exact backward kernel.
- PSVO   full FFBSi: reverse pass re-weights cached forward particles with
         w̃_t^{m,j} ∝ Ŵ_t^j f(x̃_{t+1}^m | X_t^j) and categorically samples M
         backward trajectories over the K-particle support (O(K·M·T) pairwise
         transition densities — the hot spot, a batched MLP forward).
         Rao-Blackwellizing the atom probabilities with the same filter
         surrogates makes the importance weight collapse *exactly* to the
         forward log Ẑ (the derivation telescopes: every g, f, and mixture
         term cancels), so the reported ELBO is the forward bound, and the
         smoothing pass contributes its learning signal through an
         expectation-maximization surrogate: loss adds
         −(1/M) Σ_m [log p_θ(x̃^m, y) − stop_grad(·)], i.e. zero value but the
         model-fit gradient evaluated on *smoothed* trajectories — the reason
         PSVO recovers dynamics that filtering objectives miss.
"""

from __future__ import annotations

import dataclasses
from dataclasses import dataclass
from typing import Optional

import jax
import jax.numpy as jnp

from psvo_tpu.config import Config
from psvo_tpu.distributions import (
    _HALF_LOG_2PI,
    _MIN_LOGP,
    log_normalize,
    mvn_diag_log_prob,
)
from psvo_tpu.models.ssm import SSM
from psvo_tpu.smc import FilterResult, forward_filter


@jax.tree_util.register_dataclass
@dataclass
class ObjectiveOutput:
    loss: jax.Array  # scalar, to minimize
    elbo: jax.Array  # [B] per-trajectory bound (the reported "log_ZSMC")
    metrics: dict  # scalars for logging
    smoothed: Optional[jax.Array] = None  # [T, B, M, Dx] backward trajectories
    filter_result: Optional[FilterResult] = None


def _pairwise_support_terms(ssm: SSM, params, x_support: jax.Array, u=None):
    """Support-side pieces of the pairwise transition density.

    Everything that depends only on (params, x_support, u) — the transition
    trunk, precision products, and the query-independent Mahalanobis /
    log-det terms — separated from the query-side contractions so the FFBSi
    reverse scan can precompute it for ALL T in one bulk trunk call
    (leading dims broadcast: x_support may be [T, B, Dx, K]).

    Returns a dict streamed through the scan; consumed by
    _pairwise_query_logp."""
    d = x_support.shape[-2]
    if ssm.f_tril_head:
        mean, diag, off = ssm.transition_tril_cm(params, x_support, u)

        def L(i, j):  # packed lower-tri entry, i >= j
            return diag[..., i, :] if i == j else off[..., i * (i - 1) // 2 + j, :]

        linv = [[None] * d for _ in range(d)]
        for i in range(d):
            linv[i][i] = 1.0 / diag[..., i, :]
            for j in range(i - 1, -1, -1):
                acc = sum(L(i, kk) * linv[kk][j] for kk in range(j, i))
                linv[i][j] = -acc * linv[i][i]
        # whitened mean rows m̃ = L⁻¹ m, then w = L⁻ᵀ m̃ = P m
        m_w = [
            sum(linv[i][j] * mean[..., j, :] for j in range(i + 1))
            for i in range(d)
        ]
        t3 = sum(v * v for v in m_w)  # [..., K]
        w = jnp.stack(
            [sum(linv[i][j] * m_w[i] for i in range(j, d)) for j in range(d)],
            axis=-2,
        )  # [..., D, K] = P m
        pflat = jnp.stack(
            [
                sum(linv[i][a] * linv[i][b] for i in range(max(a, b), d))
                for a in range(d)
                for b in range(d)
            ],
            axis=-2,
        )  # [..., D², K] row-major vec(P)
        logdet = jnp.sum(jnp.log(diag), axis=-2)
        return {"pflat": pflat, "w": w, "c": -0.5 * t3 - logdet - d * _HALF_LOG_2PI}
    if ssm.f_tril:
        # constant full covariance: whiten the support mean once; the query
        # whitens per step against the same (tiny, broadcast) factor
        mean, chol = ssm.transition_full_cm(params, x_support, u)
        solve = lambda v: jax.scipy.linalg.solve_triangular(
            jnp.broadcast_to(chol, (*v.shape[:-2], d, d)), v, lower=True
        )
        mean = solve(mean)
        r = jnp.ones_like(mean)
        logdet = jnp.sum(jnp.log(jnp.diagonal(chol)))
        t3 = jnp.sum(mean * mean, axis=-2)
        return {
            "r": r,
            "mr": mean,
            "c": -0.5 * t3 - logdet - d * _HALF_LOG_2PI,
            "chol": jnp.broadcast_to(chol, (*x_support.shape[:-2], d, d)),
        }
    mean, scale = ssm.transition_params_cm(params, x_support, u)  # [..., Dx, K]
    r = 1.0 / (scale * scale)
    logdet = jnp.sum(jnp.log(scale), axis=-2)
    t3 = jnp.sum(mean * mean * r, axis=-2)
    return {"r": r, "mr": mean * r, "c": -0.5 * t3 - logdet - d * _HALF_LOG_2PI}


def _pairwise_query_logp(ssm: SSM, sup: dict, x_query: jax.Array) -> jax.Array:
    """Query-side contractions of the pairwise density: sup (one step's
    support terms, [B, ..., K]) × x_query [B, M, Dx] -> [B, M, K].

    With r = 1/s², the squared Mahalanobis term expands into matmul
    contractions over d instead of a broadcast [B,M,K,D] tensor:

        Σ_d (q_d − m_dj)²·r_dj = Σ_d q_d²·r_dj − 2·Σ_d q_d·(m·r)_dj + Σ_d m²r

    (the last term rides sup["c"]). HIGHEST precision: t1/t2/c are large
    near-cancelling quantities (~x²/σ², 1e3-1e4 at Lorenz-63 state scales);
    a reduced-precision default (bf16 or TF32 operands) would leave
    O(1-100 nat) noise in the backward categorical logits after the
    cancellation. These contractions are tiny next to the MLP cost."""
    hi = jax.lax.Precision.HIGHEST
    if ssm.f_tril_head:
        qq = (x_query[..., :, None] * x_query[..., None, :]).reshape(
            *x_query.shape[:-1], x_query.shape[-1] ** 2
        )
        t1 = jnp.einsum("bmp,bpk->bmk", qq, sup["pflat"], precision=hi)
        t2 = jnp.einsum("bmd,bdk->bmk", x_query, sup["w"], precision=hi)
        logp = -0.5 * t1 + t2 + sup["c"][:, None, :]
        return jnp.maximum(logp, _MIN_LOGP)
    if ssm.f_tril:
        d = x_query.shape[-1]
        x_query = jnp.swapaxes(
            jax.scipy.linalg.solve_triangular(
                jnp.broadcast_to(sup["chol"], (*x_query.shape[:-2], d, d)),
                jnp.swapaxes(x_query, -1, -2),
                lower=True,
            ),
            -1, -2,
        )
    t1 = jnp.einsum("bmd,bdk->bmk", x_query * x_query, sup["r"], precision=hi)
    t2 = jnp.einsum("bmd,bdk->bmk", x_query, sup["mr"], precision=hi)
    logp = -0.5 * t1 + t2 + sup["c"][:, None, :]
    return jnp.maximum(logp, _MIN_LOGP)


def _pairwise_transition_logp(
    ssm: SSM, params, x_support: jax.Array, x_query: jax.Array, u=None
) -> jax.Array:
    """log f(x_query^m | x_support^j) for all (m, j):
    x_support [B,Dx,K] (channel-major), x_query [B,M,Dx] -> [B,M,K].

    The O(K·M·D) inner loop of FFBSi (SURVEY.md §3.3 "THE hot spot of PSVO").
    One batched MLP forward over the K support points gives (m, s) [B,Dx,K];
    the Mahalanobis term then rides three dot_general contractions (see
    _pairwise_query_logp). Split as support-terms + query-contractions so
    the FFBSi scan bulk-precomputes the support side
    (_pairwise_support_terms).
    """
    return _pairwise_query_logp(
        ssm, _pairwise_support_terms(ssm, params, x_support, u), x_query
    )



def _predictive_mixture_logp(
    ssm: SSM, params, x_prev: jax.Array, logw_prev: jax.Array, x_query: jax.Array, u=None
) -> jax.Array:
    """log p̂(x_query | y_{1:t}) = logsumexp_j [ logŴ_t^j + log f(x_query|X_t^j) ]."""
    logw_norm, _ = log_normalize(logw_prev, axis=-1)  # [B, K]
    pair = _pairwise_transition_logp(ssm, params, x_prev, x_query, u)  # [B, M, K]
    return jax.scipy.special.logsumexp(pair + logw_norm[:, None, :], axis=-1)


def _gumbel_from_keys(keys, shape):
    """[T', *shape] Gumbel noise, one key per step (bulk RNG outside the
    FFBSi scan; per-step generation kept key-compatible with the segmented
    sweep, which draws its noise segment by segment from the same keys)."""
    return jax.vmap(lambda kk: jax.random.gumbel(kk, shape))(keys)


def _particle_mesh():
    """The active mesh iff the particle axis is actually sharded."""
    from psvo_tpu.parallel import context

    mesh = context.get_mesh()
    if mesh is not None and mesh.shape.get(context.PARTICLE_AXIS, 1) > 1:
        return mesh
    return None


def _sample_final_particles(key, fwd: FilterResult, m: int):
    """Draw M trajectory anchors from the final filtering distribution.

    Explicit Gumbel-argmax (what `jax.random.categorical` is internally):
    generating the noise as a named array lets the particle-sharded path
    (ops/sharded_ffbsi.sharded_anchor) consume the SAME noise and reproduce
    the single-device draw bit-exactly. Returns (x̃_T [B, M, Dx],
    anchor log-pmf [B, M])."""
    logw_norm, _ = log_normalize(fwd.logw_last, axis=-1)  # [B, K]
    b, k = logw_norm.shape
    gum = jax.random.gumbel(key, (b, m, k))
    mesh = _particle_mesh()
    if mesh is not None:
        from psvo_tpu.ops.sharded_ffbsi import sharded_anchor

        return sharded_anchor(mesh, logw_norm, fwd.x_last, gum)
    idx = jnp.argmax(logw_norm[:, None, :] + gum, axis=-1)  # [B, M]
    x_t = jnp.take_along_axis(fwd.x_last, idx[:, None, :], axis=-1)  # [B, Dx, M]
    lwn_sel = jnp.take_along_axis(logw_norm, idx, axis=-1)  # [B, M]
    return jnp.swapaxes(x_t, -1, -2), lwn_sel  # [B, M, Dx]


@jax.named_scope("svo_backward")
def _svo_backward(ssm: SSM, params, key, ys_tm, ctrl_tm, fwd: FilterResult, m: int):
    """Backward simulation with the learned proposal q_b; returns (logw̃ [B,M], x̃ [T,B,M,Dx])."""
    t_steps = ys_tm.shape[0]
    batch = ys_tm.shape[1]
    k_anchor, k_eps = jax.random.split(key)
    x_tilde_t, _ = _sample_final_particles(k_anchor, fwd, m)  # [B, M, Dx]
    # bulk RNG: all backward-proposal noise in one call (scan is latency-bound)
    eps_scan = jax.random.normal(k_eps, (t_steps - 1, batch, m, x_tilde_t.shape[-1]))

    # q-side T-term: continuous filter-density surrogate ρ_T (module docstring).
    log_g_t = ssm.emission_log_prob(params, x_tilde_t, ys_tm[-1][:, None, :])
    log_pred = _predictive_mixture_logp(
        ssm, params, fwd.xs[-2], fwd.logws[-2], x_tilde_t, ctrl_tm[-1]
    )
    log_rho_t = log_g_t + log_pred - fwd.increments[-1][:, None]  # [B, M]

    # p-side T-term: log g(y_T | x̃_T); transition terms accumulate in the scan.
    logp = log_g_t
    logq = log_rho_t

    # RNN option (smc.qb_rnn): backward-GRU summaries h_t of y_{t:T},
    # computed for ALL t in one cheap [B, ·] reverse scan outside the
    # M-path math; zero-width placeholder keeps the scan structure static
    if ssm.qb_rnn:
        h_scan = ssm.backward_rnn_summaries(params, ys_tm)[:-1]  # [T-1, B, H]
    else:
        h_scan = jnp.zeros((t_steps - 1, batch, 0), jnp.float32)

    def body(carry, inputs):
        x_next, logp, logq = carry
        y_t, u_next, eps_t, h_t = inputs  # u_next: control at t+1 (into x_next)
        mean_b, scale_b = ssm.backward_propose(
            params, x_next, y_t[:, None, :],
            h_t[:, None, :] if ssm.qb_rnn else None,
        )
        x_t = mean_b + scale_b * eps_t  # [B, M, Dx] reparameterized draw
        logp = (
            logp
            + ssm.transition_log_prob(params, x_t, x_next, u_next)
            + ssm.emission_log_prob(params, x_t, y_t[:, None, :])
        )
        logq = logq + mvn_diag_log_prob(x_t, mean_b, scale_b)
        return (x_t, logp, logq), x_t

    # reverse scan over t = T-2 .. 0
    (x_first, logp, logq), xs_rev = jax.lax.scan(
        body,
        (x_tilde_t, logp, logq),
        (ys_tm[:-1], ctrl_tm[1:], eps_scan, h_scan),
        reverse=True,
    )
    logp = logp + ssm.prior_log_prob(params, x_first)

    x_tilde = jnp.concatenate([xs_rev, x_tilde_t[None]], axis=0)  # [T, B, M, Dx]
    return logp - logq, x_tilde


def _make_ffbsi_body(ssm: SSM, params):
    """One FFBSi reverse step: re-weight the forward support against the
    current backward state, draw an ancestor per path, accumulate log p and
    the discrete path pmf log q̃ (the reference-form sampled-trajectory
    proposal mass — see the psvo_direct notes in make_objective).

    The body only SELECTS: the path log-joint is recomputed after the sweep
    on the selected trajectories (`_selected_path_log_joint`), so the in-body
    logp accumulator (kept for carry-shape compatibility with the sharded
    sweep) is discarded by the callers and the log_g stream is zeros. The
    pairwise density's support-side terms (transition trunk included) are
    bulk-hoisted (`_pairwise_support_terms`), so the reverse scan body runs
    NO MLPs — only the two query contractions, the categorical draw, and
    gathers."""

    def body(carry, inputs):
        x_next, logp, logq = carry
        # support [B,Dx,K], bulk support-side density terms, normalized
        # logw [B,K], bulk emission [B,K], Gumbel noise [B,M,K]
        x_t_support, sup_t, logw_norm, log_g_t, gum_t = inputs

        pair = _pairwise_query_logp(ssm, sup_t, x_next)
        logits = pair + logw_norm[:, None, :]  # [B, M, K] backward weights
        # categorical draw as Gumbel-argmax over PRE-GENERATED noise (bulk
        # RNG outside the scan; also what lets the particle-sharded sweep
        # reproduce this path bit-exactly)
        idx = jnp.argmax(logits + gum_t, axis=-1)  # [B, M]
        idx3 = idx[..., None]
        pair_sel = jnp.take_along_axis(pair, idx3, axis=-1)[..., 0]  # log f
        lwn_sel = jnp.take_along_axis(logw_norm, idx, axis=-1)
        lse = jax.scipy.special.logsumexp(logits, axis=-1)  # [B, M]
        logq = logq + pair_sel + lwn_sel - lse
        x_t = jnp.swapaxes(
            jnp.take_along_axis(x_t_support, idx[:, None, :], axis=-1), -1, -2
        )  # [B, M, Dx]

        logp = logp + pair_sel + jnp.take_along_axis(log_g_t, idx, axis=-1)
        return (x_t, logp, logq), x_t

    return body


def _selected_path_log_joint(ssm: SSM, params, x_tilde_c, ys_tm, ctrl_tm):
    """log p_θ(x̃, y) [B, M], evaluated directly on the selected trajectories.

    `x_tilde_c` arrives COMPACT [T, B, M·Dx]. Callers invoke this through
    jax.checkpoint so the MLP row/hidden activations are recomputed in the
    backward rather than persisting O(T·B·M·hidden) f32.

    Mathematically identical — value AND gradient — to gathering the selected
    entries of full-support density evaluations: the selected particle IS the
    support atom (x̃_t = X_t^{idx}), the densities are pointwise in the
    particle, and the discrete index carries no gradient, so evaluation and
    gather commute. But this form costs O(T·B·M) trunk rows instead of
    O(T·B·K): at the BASELINE PSVO config (K=1024, M=16) that is 64× less
    work, and it removes the K-wide trunk *backward* from the train step
    entirely."""
    t_steps, b, md = x_tilde_c.shape
    m = md // ssm.dx
    if t_steps - 1 >= 2 * _LOGJOINT_CHUNK and (t_steps - 1) % _LOGJOINT_CHUNK == 0:
        return _logjoint_chunked(ssm, params, x_tilde_c, ys_tm, ctrl_tm, m)
    x_tilde = x_tilde_c.reshape(t_steps, b, m, ssm.dx)
    u = None
    if ssm.di:
        u = jnp.broadcast_to(
            ctrl_tm[1:, :, None, :], (t_steps - 1, b, m, ssm.di)
        )
    lp_f = ssm.transition_log_prob(params, x_tilde[:-1], x_tilde[1:], u)
    lp_g = ssm.emission_log_prob(params, x_tilde, ys_tm[:, :, None, :])
    return (
        jnp.sum(lp_f, axis=0)
        + jnp.sum(lp_g, axis=0)
        + ssm.prior_log_prob(params, x_tilde[0])
    )


# Time-chunk length of the long-T log-joint scan. The chunked form bounds
# every [*, B, M, ·] intermediate (the MLP activations, their remat copies
# and the summed cotangent) to L steps: a lax.scan over time chunks whose
# checkpointed body re-derives them in the backward, with the previous
# chunk's boundary frame carried for the transition pairs.
# Engaged only when (T−1) is a multiple of the chunk with ≥ 2 chunks —
# reference-scale T (~100) keeps the direct form; long-T runs use
# T = 2^k + 1 which always divides.
_LOGJOINT_CHUNK = 512


def _logjoint_chunked(ssm: SSM, params, x_c, ys_tm, ctrl_tm, m: int):
    """Chunked evaluation of the selected-path log-joint — value- and
    gradient-identical to the direct form (test:
    test_logjoint_chunked_matches_direct), O(L) instead of O(T) peak for
    the [*, B, M, ·] intermediates."""
    t_steps, b, _ = x_c.shape
    dx = ssm.dx
    L = _LOGJOINT_CHUNK
    nc = (t_steps - 1) // L

    x0 = x_c[0].reshape(b, m, dx)
    lp0 = ssm.prior_log_prob(params, x0) + jnp.sum(
        ssm.emission_log_prob(params, x0[None], ys_tm[0][None, :, None, :]),
        axis=0,
    )
    xs = x_c[1:].reshape(nc, L, b, m * dx)
    ys = ys_tm[1:].reshape(nc, L, b, -1)
    us = ctrl_tm[1:].reshape(nc, L, b, ssm.di)

    def body(carry_prev, inp):
        xc, yc, uc = inp
        xck = xc.reshape(L, b, m, dx)
        prev = carry_prev.reshape(1, b, m, dx)
        pairs_prev = jnp.concatenate([prev, xck[:-1]], axis=0)
        u = None
        if ssm.di:
            u = jnp.broadcast_to(uc[:, :, None, :], (L, b, m, ssm.di))
        lp_f = ssm.transition_log_prob(params, pairs_prev, xck, u)
        lp_g = ssm.emission_log_prob(params, xck, yc[:, :, None, :])
        return xc[-1], jnp.sum(lp_f, axis=0) + jnp.sum(lp_g, axis=0)

    _, lps = jax.lax.scan(jax.checkpoint(body), x_c[0], (xs, ys, us))
    return lp0 + jnp.sum(lps, axis=0)


@jax.named_scope("ffbsi_backward")
def _ffbsi_backward(
    ssm: SSM,
    params,
    key,
    ys_tm,
    ctrl_tm,
    fwd: FilterResult,
    m: int,
    *,
    differentiable_sweep: bool = False,
):
    """FFBSi discrete backward simulation over the forward support.

    Returns (smoothed [T,B,M,Dx], log p(smoothed, y) [B,M], log q̃ [B,M]) —
    the smoothed trajectories, the model log-joint along them (the PSVO
    EM-surrogate), and the discrete path pmf of the backward draws.

    The sweep itself only produces the *selections* (and the logq̃ pmf): the
    log-joint is recomputed post-sweep on the selected paths
    (`_selected_path_log_joint`), which is gradient-identical and 64× cheaper
    than differentiating the K-wide support densities. With
    differentiable_sweep=False (the default forward-bound mode) the K-wide
    pairwise logits then feed only the argmax draws and the logq̃ metric, so
    they run under stop_gradient — the full-support trunk backward vanishes
    from the step. The direct bound differentiates logq̃'s logsumexp over the
    support, so it keeps the sweep differentiable.
    """
    t_steps = ys_tm.shape[0]
    k_anchor, k_cat = jax.random.split(key)
    x_tilde_t, lwn_anchor = _sample_final_particles(k_anchor, fwd, m)
    logq = lwn_anchor  # [B, M] anchor pmf
    logp0 = jnp.zeros_like(logq)  # in-sweep logp is discarded (see above)
    cat_keys = jax.random.split(k_cat, t_steps - 1)
    gum = _gumbel_from_keys(cat_keys, (*logq.shape, fwd.logw_last.shape[-1]))
    # bulk hoists (the scan is launch-bound): normalized forward weights and
    # the pairwise density's support-side terms (the transition trunk
    # included) for all T in one call each — the reverse scan body runs NO
    # MLPs at all
    logw_norm_all, _ = log_normalize(fwd.logws[:-1], axis=-1)  # [T-1, B, K]
    sup_all = _pairwise_support_terms(ssm, params, fwd.xs[:-1], ctrl_tm[1:])
    if not differentiable_sweep:
        sup_all = jax.tree_util.tree_map(jax.lax.stop_gradient, sup_all)
        logw_norm_all = jax.lax.stop_gradient(logw_norm_all)
    # the emission stream is dead weight now that logp is recomputed
    # post-sweep — feed zeros (the sweep bodies keep their shape)
    log_g_support = jnp.zeros(logw_norm_all.shape, logw_norm_all.dtype)

    mesh = _particle_mesh()
    if mesh is not None:
        # particle-sharded sweep: shard_map island (global Gumbel-argmax +
        # psum-gathered selections) — bit-identical to the lax.scan below on
        # the same noise; see ops/sharded_ffbsi.py
        from psvo_tpu.ops.sharded_ffbsi import sharded_ffbsi_sweep

        x_first, _, logq, xs_rev = sharded_ffbsi_sweep(
            mesh,
            lambda sup_t, xq: _pairwise_query_logp(ssm, sup_t, xq),
            fwd.xs[:-1], sup_all, logw_norm_all, log_g_support, gum,
            x_tilde_t, logp0, logq,
        )
    else:
        (x_first, _, logq), xs_rev = jax.lax.scan(
            _make_ffbsi_body(ssm, params),
            (x_tilde_t, logp0, logq),
            (fwd.xs[:-1], sup_all, logw_norm_all, log_g_support, gum),
            reverse=True,
        )
    return _stitch_and_logjoint(
        ssm, params, [xs_rev], x_tilde_t, ys_tm, ctrl_tm, logq
    )


def _stitch_and_logjoint(ssm, params, pieces, x_tilde_t, ys_tm, ctrl_tm, logq):
    """Concatenate smoothed pieces ([L, B, M, Dx]) with the anchor, evaluate
    the path log-joint through jax.checkpoint on the compact [T, B, M·Dx]
    layout, and return
    (x_tilde [T, B, M, Dx], logp, logq). The full-layout return exists for
    ObjectiveOutput.smoothed (plots/eval); inside a train step it is dead
    code and XLA drops it."""
    b, m = x_tilde_t.shape[0], x_tilde_t.shape[1]
    flat = [p.reshape(p.shape[0], p.shape[1], -1) for p in pieces]
    x_tilde_c = jnp.concatenate(
        [*flat, x_tilde_t.reshape(1, b, -1)], axis=0
    )
    logp = jax.checkpoint(
        _selected_path_log_joint, static_argnums=(0,)
    )(ssm, params, x_tilde_c, ys_tm, ctrl_tm)
    t_steps = x_tilde_c.shape[0]
    return x_tilde_c.reshape(t_steps, b, m, ssm.dx), logp, logq


@jax.named_scope("ffbsi_backward_segmented")
def _ffbsi_backward_segmented(
    ssm: SSM, params, key, ys_tm, enc_tm, ctrl_tm, fwd, cache, m: int, smc_cfg,
    *, differentiable_sweep: bool = False,
):
    """FFBSi over a segmented forward cache (the long-T path, SURVEY.md §5):
    each forward segment is recomputed bit-exactly from its boundary carry
    just before the reverse sweep consumes it, so only O(T/L) carries persist
    instead of the full O(T) particle history.

    Same selection-only sweep as `_ffbsi_backward`: the log-joint is
    recomputed post-sweep on the selected paths, and the K-wide logits run
    under stop_gradient unless the direct bound needs them differentiable.

    Under a particle mesh each segment's sweep (and the final t=0 step, as
    a length-1 sweep) runs through the ops/sharded_ffbsi.py shard_map
    island, chaining the (anchor, logp, logq) accumulators across segments —
    the forward recompute needs no special casing because _make_step_body
    dispatches its resample to the sharded island at trace time.
    """
    from psvo_tpu.smc import recompute_segment

    t_steps, batch = ys_tm.shape[0], ys_tm.shape[1]
    n_segments = cache.seg_x.shape[0]
    seg_len = (t_steps - 1) // n_segments

    k_anchor, k_cat = jax.random.split(key)
    x_tilde_t, lwn_anchor = _sample_final_particles(k_anchor, fwd, m)
    logp = jnp.zeros_like(lwn_anchor)  # in-sweep logp discarded (recomputed)
    logq = lwn_anchor
    cat_keys = jax.random.split(k_cat, t_steps - 1)  # cat_keys[t-1] for step t

    def _sg_unless_diff(tree):
        if differentiable_sweep:
            return tree
        return jax.tree_util.tree_map(jax.lax.stop_gradient, tree)

    body = _make_ffbsi_body(ssm, params)
    mesh = _particle_mesh()
    if mesh is not None:
        from psvo_tpu.ops.sharded_ffbsi import sharded_ffbsi_sweep

        pair_fn = lambda sup_t, xq: _pairwise_query_logp(ssm, sup_t, xq)
    ys_seg = ys_tm[1:].reshape(n_segments, seg_len, batch, -1)
    enc_seg = enc_tm[1:].reshape(n_segments, seg_len, batch, -1)
    ctrl_seg = ctrl_tm[1:].reshape(n_segments, seg_len, batch, ssm.di)

    carry = (x_tilde_t, logp, logq)
    pieces = []  # smoothed segments, collected in reverse time order
    for s in reversed(range(n_segments)):
        # schedule fence: the segment recomputes and the per-segment Gumbel
        # rng-bit-generators have no data dependence on the sweep carry, so
        # XLA may front-load ALL segments' [L, B, M, K] buffers at once.
        # Fencing each segment's inputs behind the carry serializes the
        # loop to ~one segment's working set.
        seg_x_d, seg_logw_d, keys_d, _ = jax.lax.optimization_barrier(
            (cache.seg_x, cache.seg_logw, cat_keys, carry[2])
        )
        cache_d = dataclasses.replace(
            cache, seg_x=seg_x_d, seg_logw=seg_logw_d
        )
        cat_keys_d = keys_d
        xs_seg, logws_seg = recompute_segment(
            ssm, params, smc_cfg, cache_d, s, ys_seg[s], enc_seg[s], ctrl_seg[s]
        )
        # segment s holds support entries t = 1+sL .. sL+L; the reverse sweep
        # consumes t <= T-2, so the last segment drops its final entry (that
        # time step is the anchor). Support t pairs with ys[t], the control at
        # t+1, and cat_keys[t] (cat_keys[0] is reserved for the t=0 step below).
        lo = 1 + s * seg_len
        hi = min(s * seg_len + seg_len, t_steps - 2)
        n_sup = hi - lo + 1
        if n_sup == 0:  # seg_len 1: the last segment holds only the anchor
            continue
        xs_sup, logw_sup = xs_seg[:n_sup], logws_seg[:n_sup]
        ys_sup = ys_tm[lo : hi + 1]
        ctrl_sup = ctrl_tm[lo + 1 : hi + 2]
        keys_sup = cat_keys_d[lo : hi + 1]
        gum_sup = _gumbel_from_keys(keys_sup, (batch, m, xs_sup.shape[-1]))
        lwn_sup = _sg_unless_diff(log_normalize(logw_sup, axis=-1)[0])
        lg_sup = jnp.zeros(lwn_sup.shape, lwn_sup.dtype)
        sup_sup = _sg_unless_diff(
            _pairwise_support_terms(ssm, params, xs_sup, ctrl_sup)
        )
        if mesh is not None:
            # particle-sharded per-segment sweep: same island as the
            # non-segmented path, accumulators chained through the carry
            x_q, logp_c, logq_c = carry
            x_first_seg, logp_c, logq_c, xs_rev = sharded_ffbsi_sweep(
                mesh, pair_fn, xs_sup, sup_sup, lwn_sup, lg_sup, gum_sup,
                x_q, logp_c, logq_c,
            )
            carry = (x_first_seg, logp_c, logq_c)
        else:
            carry, xs_rev = jax.lax.scan(
                body, carry,
                (xs_sup, sup_sup, lwn_sup, lg_sup, gum_sup),
                reverse=True,
            )
        pieces.append(xs_rev)

    # final reverse step: support t = 0 (the initial particles)
    lwn0 = _sg_unless_diff(log_normalize(cache.alpha0, axis=-1)[0])
    lg0 = jnp.zeros(lwn0.shape, lwn0.dtype)
    sup0 = _sg_unless_diff(
        _pairwise_support_terms(ssm, params, cache.x0, ctrl_tm[1])
    )
    gum0 = jax.random.gumbel(cat_keys[0], (batch, m, cache.x0.shape[-1]))
    if mesh is not None:
        x_first, _, logq, x0_rev = sharded_ffbsi_sweep(
            mesh, pair_fn, cache.x0[None],
            jax.tree_util.tree_map(lambda a: a[None], sup0),
            lwn0[None], lg0[None], gum0[None], *carry,
        )
        x0_tilde = x0_rev[0]
    else:
        carry, x0_tilde = body(carry, (cache.x0, sup0, lwn0, lg0, gum0))
        x_first, _, logq = carry

    return _stitch_and_logjoint(
        ssm, params, [x0_tilde[None], *reversed(pieces)],
        x_tilde_t, ys_tm, ctrl_tm, logq,
    )


def make_objective(ssm: SSM, cfg: Config):
    """Return objective_fn(params, key, ys, encoder_inputs=None, controls=None,
    noise=None) -> ObjectiveOutput.

    noise is forward_filter's testing hook (fixed proposal and resampling
    draws for the forward pass; unsegmented objectives only)."""
    smc_cfg = cfg.smc
    if smc_cfg.objective == "iwae":
        smc_cfg = dataclasses.replace(smc_cfg, resampling="none")
    if not smc_cfg.use_stop_gradient and smc_cfg.resampling == "systematic":
        # The score-function term uses the product-categorical log-prob
        # Σ_k log Ŵ[a_k], which is the ancestors' log-density only under iid
        # multinomial draws; systematic resampling shares one uniform across
        # all K ancestors, so that product is NOT its log-density and the
        # "full FIVO gradient" would be mis-specified (Maddison et al. 2017
        # derive the estimator for multinomial resampling).
        raise ValueError(
            "use_stop_gradient=False (the full FIVO gradient) requires "
            "resampling='multinomial'; systematic resampling has no "
            "product-categorical ancestor density"
        )
    segmented = smc_cfg.objective == "psvo" and smc_cfg.ffbsi_segments > 1
    needs_cache = smc_cfg.objective in ("svo", "psvo") and not segmented
    m = smc_cfg.n_smoothing_particles

    def objective(
        params, key, ys, encoder_inputs=None, controls=None, noise=None
    ) -> ObjectiveOutput:
        # q_uses_true_X debug flag (SURVEY.md §5 flag table): the caller passes
        # the true latents as encoder_inputs; here we only assert intent.
        # controls [B, T, Di] are the exogenous inputs (reference `Di`).
        k_fwd, k_bwd = jax.random.split(key)
        seg_cache = None
        if segmented:
            from psvo_tpu.smc import forward_filter_segmented

            if noise is not None:
                raise ValueError("noise= is not supported with ffbsi_segments > 1")
            fwd, seg_cache = forward_filter_segmented(
                ssm,
                params,
                k_fwd,
                ys,
                smc_cfg,
                smc_cfg.ffbsi_segments,
                encoder_inputs=encoder_inputs,
                controls=controls,
            )
        else:
            fwd = forward_filter(
                ssm,
                params,
                k_fwd,
                ys,
                smc_cfg,
                cache=needs_cache,
                encoder_inputs=encoder_inputs,
                controls=controls,
                noise=noise,
            )
        metrics = {
            "log_z_fwd": jnp.mean(fwd.log_z),
            "ess_mean": jnp.mean(fwd.ess),
            "ess_min": jnp.min(fwd.ess),
        }

        if smc_cfg.objective in ("iwae", "fivo"):
            elbo = fwd.log_z
            loss = -jnp.mean(elbo)
            if fwd.score_surrogate is not None:
                # full FIVO gradient: REINFORCE term for the resampling
                # distribution (use_stop_gradient=False); zero value.
                sur = jnp.mean(fwd.score_surrogate)
                loss = loss - (sur - jax.lax.stop_gradient(sur))
            return ObjectiveOutput(loss, elbo, metrics, filter_result=fwd)

        ys_tm = jnp.swapaxes(ys, 0, 1)  # [T, B, Dy]
        from psvo_tpu.smc import _controls_tm

        ctrl_tm = _controls_tm(controls, ys.shape[0], ys.shape[1], ssm.di)

        if smc_cfg.objective == "svo":
            logw_traj, x_tilde = _svo_backward(
                ssm, params, k_bwd, ys_tm, ctrl_tm, fwd, m
            )
            elbo = jax.scipy.special.logsumexp(logw_traj, axis=-1) - jnp.log(
                float(m)
            )  # [B]
            loss = -jnp.mean(elbo)
            metrics["elbo_svo"] = jnp.mean(elbo)
            return ObjectiveOutput(loss, elbo, metrics, x_tilde, fwd)

        if smc_cfg.objective == "psvo":
            if segmented:
                enc_tm = (
                    jnp.swapaxes(encoder_inputs, 0, 1)
                    if encoder_inputs is not None
                    else ys_tm
                )
                x_tilde, logp_joint, logq_pmf = _ffbsi_backward_segmented(
                    ssm, params, k_bwd, ys_tm, enc_tm, ctrl_tm, fwd, seg_cache,
                    m, smc_cfg,
                    differentiable_sweep=smc_cfg.psvo_bound == "direct",
                )
            else:
                x_tilde, logp_joint, logq_pmf = _ffbsi_backward(
                    ssm, params, k_bwd, ys_tm, ctrl_tm, fwd, m,
                    differentiable_sweep=smc_cfg.psvo_bound == "direct",
                )
            # Reference-form sampled-trajectory bound (SURVEY.md §3.3 "PSVO
            # objective on smoothed paths"): logsumexp_m(log p − log q̃) −
            # log M with q̃ the DISCRETE backward path pmf. Dimensional
            # caveat, documented: log p is a density while log q̃ is a pmf
            # over the K-particle support, so this quantity carries a
            # support-size offset (grows ~O(T·log K)) — it tracks smoothing
            # quality and matches the reference's printed per-trajectory
            # objective shape, but it is NOT calibrated against log p(y)
            # the way the forward bound is. The well-posed Rao-Blackwellized
            # form of the same estimator collapses exactly to fwd.log_z
            # (module docstring), which is why that is the reported ELBO.
            direct = jax.scipy.special.logsumexp(
                logp_joint - logq_pmf, axis=-1
            ) - jnp.log(float(m))
            elbo = fwd.log_z  # exact value after Rao-Blackwell cancellation
            em_term = jnp.mean(logp_joint)
            if smc_cfg.psvo_bound == "direct":
                # train on the sampled-trajectory bound (reference form):
                # reparameterized through the support atoms, stop-gradient
                # through the categorical draws (the paper's estimator)
                loss = -jnp.mean(direct)
            else:
                # forward bound + zero-valued EM surrogate carrying the
                # smoothed-path model gradient
                loss = -jnp.mean(elbo) - (
                    em_term - jax.lax.stop_gradient(em_term)
                )
            metrics["log_joint_smoothed"] = em_term
            metrics["elbo_psvo_direct"] = jnp.mean(direct)
            return ObjectiveOutput(loss, elbo, metrics, x_tilde, fwd)

        raise ValueError(f"unknown objective {smc_cfg.objective!r}")

    return objective
