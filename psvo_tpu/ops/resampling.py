"""On-device particle resampling: multinomial and systematic.

Covers the reference's ancestor-sampling step (`SMC/SMC_base.py`'s
`resample`/`sample_ancestors`, SURVEY.md §2-A — there a
`tf.categorical`-style multinomial; BASELINE.json also pins systematic
resampling in the family).

Design: both schemes reduce to inverse-CDF lookup —
cumulative-sum the normalized weights, then for K quantile positions u_i find
`a_i = #{j : C_j <= u_i}` and gather. The two schemes differ ONLY in the
positions:

  systematic:  u_i = (i + u0) / K     with one shared u0 ~ U[0,1)
  multinomial: u_i ~ U[0,1) iid       (inverse-CDF of iid uniforms is exact
                                       multinomial sampling)

The lookup stays on-device inside the jitted scan — no host sync, static
shapes. Systematic positions take the O(K) histogram form
(`systematic_indices_histogram`, one scatter-add and one cumsum);
multinomial positions take a vmapped `jnp.searchsorted`. Both are checked
against a NumPy inverse-CDF oracle in tests/test_resampling.py.

Gradient policy: ancestor indices are integers — no gradient path exists
through them; the FIVO estimator's stop-gradient treatment of resampling
(SURVEY.md §3.2) is handled in `psvo_tpu.smc` by resetting post-resampling
log-weights with `stop_gradient` on the normalizer.
"""

from __future__ import annotations

from functools import partial

import jax
import jax.numpy as jnp

from psvo_tpu.distributions import effective_sample_size, log_normalize


def raw_uniforms(key: jax.Array, batch: int, k: int, method: str) -> jax.Array:
    """The raw uniforms a resampling step consumes: [B] (systematic: one
    shared offset per row) or [B, K] (multinomial: iid)."""
    if method == "systematic":
        return jax.random.uniform(key, (batch,))
    if method == "multinomial":
        return jax.random.uniform(key, (batch, k))
    raise ValueError(f"unknown resampling method {method!r}")


def quantile_positions_from_raw(u_raw: jax.Array, k: int, method: str) -> jax.Array:
    """[..., K] inverse-CDF query positions in [0, 1), sorted along K.

    Broadcasts over leading axes, so ALL T steps' positions can be built in
    one shot outside the time scan (see `bulk_positions`).
    """
    if method == "systematic":
        return (jnp.arange(k, dtype=jnp.float32) + u_raw[..., None]) / k
    if method == "multinomial":
        # sorting keeps the searchsorted output monotone (ancestor indices
        # come out sorted, like systematic ones).
        return jnp.sort(u_raw, axis=-1)
    raise ValueError(f"unknown resampling method {method!r}")


def bulk_positions(
    key: jax.Array, t_steps: int, batch: int, k: int, method: str
) -> jax.Array:
    """[T, B, K] quantile positions for a whole filtering pass, one RNG call."""
    if method == "systematic":
        u_raw = jax.random.uniform(key, (t_steps, batch))
    else:
        u_raw = jax.random.uniform(key, (t_steps, batch, k))
    return quantile_positions_from_raw(u_raw, k, method)


def quantile_positions(
    key: jax.Array, batch: int, k: int, method: str
) -> jax.Array:
    return quantile_positions_from_raw(raw_uniforms(key, batch, k, method), k, method)


def inverse_cdf_indices(cumw: jax.Array, u: jax.Array) -> jax.Array:
    """a_i = #{j : C_j <= u_i} for each batch row; clipped to [0, K-1].

    `cumw` [B, K] is the inclusive cumulative sum of normalized weights
    (C_{K-1} ≈ 1); `u` [B, K] the query positions.
    """
    find = partial(jnp.searchsorted, side="right", method="sort")
    idx = jax.vmap(find)(cumw, u)
    return jnp.minimum(idx, cumw.shape[-1] - 1).astype(jnp.int32)


def systematic_indices_histogram(cumw: jax.Array, u0: jax.Array) -> jax.Array:
    """O(K) systematic ancestor indices via histogram + cumsum (no search).

    For affine positions u_i = (i + u0)/K the inverse CDF collapses:
    a_i = #{j : C_j <= u_i} = #{j : ceil(K·C_j − u0) <= i}, so bucket each
    particle at v_j = ceil(K·C_j − u0) and prefix-sum the histogram — one
    scatter-add and one cumsum instead of a sort-merge over 2K elements.

    cumw [B, K] inclusive normalized CDF; u0 [B] in [0, 1).
    """
    batch, k = cumw.shape
    v = jnp.ceil(k * cumw - u0[:, None]).astype(jnp.int32)
    v = jnp.clip(v, 0, k)  # v == k: particle past the last position, never drawn
    hist = jnp.zeros((batch, k + 1), jnp.int32)
    hist = hist.at[jnp.arange(batch)[:, None], v].add(1)
    idx = jnp.cumsum(hist[:, :k], axis=-1)
    return jnp.minimum(idx, k - 1).astype(jnp.int32)


def resample_indices(
    key: jax.Array, logw: jax.Array, method: str = "systematic"
) -> jax.Array:
    """Ancestor indices [B, K] from unnormalized log-weights [B, K]."""
    batch, k = logw.shape
    logw_norm, _ = log_normalize(logw, axis=-1)
    w = jnp.exp(logw_norm)
    cumw = jnp.cumsum(w, axis=-1)
    u = quantile_positions(key, batch, k, method)
    return inverse_cdf_indices(cumw, u)


def gather_particles(x: jax.Array, idx: jax.Array) -> jax.Array:
    """Gather along the particle (last) axis: x [B, D, K], idx [B, K] -> [B, D, K].

    Channel-major layout: the K axis is last; the gather broadcasts the
    [B, 1, K] index over the feature axis. Its VJP is the exact
    scatter-add of the cotangent onto the chosen ancestors.
    """
    return jnp.take_along_axis(x, idx[:, None, :], axis=-1)


def maybe_resample(
    u: jax.Array,
    logw: jax.Array,
    x: jax.Array,
    *,
    method: str = "systematic",
    ess_threshold: float = 1.0,
) -> tuple[jax.Array, jax.Array, jax.Array, jax.Array, jax.Array]:
    """ESS-adaptive resampling step for one scan iteration (channel-major x).

    `u` is the step's pre-generated [B, K] quantile positions — see
    `bulk_positions` (positions for ALL steps are built outside the scan).
    Returns (x_out [B,D,K], logw_out [B,K], did_resample [B] bool, ess [B],
    idx [B,K] the ancestor indices — consumed by the score-function gradient
    term when `use_stop_gradient=False`).
    Resampling happens per batch row where ESS/K < ess_threshold (the
    reference resamples unconditionally, i.e. threshold=1.0). Both branches
    are computed and selected with `where` — static shapes, no `cond`.

    Post-resampling weights reset to uniform in the *normalized* sense: the
    carried `logw_out` is 0 for resampled rows, and the incremental weight at
    the next step starts fresh (FIVO semantics).
    """
    batch, k = logw.shape
    ess = effective_sample_size(logw, axis=-1)
    if ess_threshold >= 1.0:
        # the reference resamples unconditionally; a STATIC `do` lets XLA
        # fold the three per-step selects and the logw reset to constants
        # (a data-dependent ess/K < 1.0 would also silently SKIP the
        # resample on exactly-uniform weights)
        do = jnp.ones((batch,), bool)
    else:
        do = ess / k < ess_threshold  # [B] bool

    logw_norm, _ = log_normalize(logw, axis=-1)
    cumw = jnp.cumsum(jnp.exp(logw_norm), axis=-1)
    if method == "systematic":
        # recover the shared offset from the first affine position
        idx = systematic_indices_histogram(cumw, u[:, 0] * k)
    else:
        idx = inverse_cdf_indices(cumw, u)
    x_res = gather_particles(x, idx)
    x_out = jnp.where(do[:, None, None], x_res, x)
    logw_out = jnp.where(do[:, None], jnp.zeros_like(logw), logw)
    return x_out, logw_out, do, ess, idx
