"""Hierarchical sharded resampling over the particle mesh axis.

SURVEY.md §7 hard-part 1 ("the novel engineering in the whole build"): when K
shards over the device mesh, resampling needs a *global* view of the weights. Left to
GSPMD, the inverse-CDF gather forces an all-gather of the full [B, D, K]
particle tensor every step (verified in the round-2 HLO dump:
`f32[2,8,256] all-gather`), replicating both memory and gather compute on
every device. This module replaces that with the hierarchical scheme inside a
`shard_map` island — manual SPMD, so GSPMD never sees the data-dependent
gather:

1. shard-local weight sums; `all_gather` of the P scalars per row gives every
   shard the global total and the mass offset of each shard (prefix sum) —
   the only globally-replicated objects are [B, P] scalars;
2. each shard owns its K/P output slots; the slot's global quantile position
   U locates its source shard by comparing against the P offsets;
3. a ring of P−1 `ppermute` steps rotates (local CDF, particles) around the
   particle axis; at each step a shard-local inverse-CDF + gather picks the
   slots whose source is the currently-held shard (a shard-local
   searchsorted + gather).

Equivalence with the single-device inverse-CDF is exact up to float-boundary
ties (per-shard cumsum + offset vs one global cumsum), tested on the 8
virtual-device mesh in tests/test_sharding.py.

Gradient semantics match `resampling.maybe_resample`: the gather is the exact
selection matrix for x; ancestor indices carry no gradient (stop-gradient
through the discrete choice). `ppermute`/`where` compose with JAX AD, so the
selection VJP routes cotangents back through the reverse ring automatically.
"""

from __future__ import annotations

from functools import partial

import jax
import jax.numpy as jnp
from jax.sharding import Mesh, PartitionSpec as P

from psvo_tpu.parallel import context


def sharded_maybe_resample(
    mesh: Mesh,
    u: jax.Array,
    logw: jax.Array,
    x: jax.Array,
    *,
    method: str = "systematic",
    ess_threshold: float = 1.0,
):
    """ESS-adaptive resampling step under a ("data", "particle") mesh.

    Same contract as `resampling.maybe_resample` (u [B,K] sorted positions,
    logw [B,K], x [B,D,K] channel-major) -> (x_out, logw_out, did, ess, idx),
    with B sharded over "data" and K over "particle". `method` only labels
    the positions' provenance — both schemes reduce to the same inverse-CDF.
    """
    pd, pp = context.DATA_AXIS, context.PARTICLE_AXIS
    spec_w = P(pd, pp)
    spec_x = P(pd, None, pp)
    island = jax.shard_map(
        partial(_island, ess_threshold=ess_threshold),
        mesh=mesh,
        in_specs=(spec_w, spec_w, spec_x),
        out_specs=(spec_x, spec_w, P(pd), P(pd), spec_w),
        check_vma=False,
    )
    return island(u, logw, x)


def _local_lookup(rel, logw_r, x_r, s_r):
    """Shard-local inverse-CDF + gather against the currently-held shard.

    rel [b, Ks] mass positions relative to the held shard's offset (sorted;
    out-of-shard queries fall outside [0, s_r) and are masked by the caller);
    logw_r/x_r the held shard's log-weights and particles; s_r [b, 1] the
    held shard's weight sum (in the global max-shifted units).
    Returns (a [b, Ks] local indices, got [b, D, Ks] gathered particles).
    """
    m = jnp.max(logw_r, axis=-1, keepdims=True)
    # recompute the held shard's CDF in ITS OWN max units, then rescale the
    # queries to match (cheaper than rotating the CDF alongside x)
    w_r = jnp.exp(logw_r - m)
    cum_r = jnp.cumsum(w_r, axis=-1)
    scale = cum_r[:, -1:] / jnp.maximum(s_r, 1e-37)
    find = partial(jnp.searchsorted, side="right")
    a = jax.vmap(find)(cum_r, rel * scale)
    a = jnp.minimum(a, logw_r.shape[-1] - 1).astype(jnp.int32)
    got = jnp.take_along_axis(x_r, a[:, None, :], axis=-1)
    return a, got


def _island(u_loc, logw_loc, x_loc, *, ess_threshold):
    """Per-shard body. u_loc [b, Ks] this shard's output slots' positions."""
    pp = context.PARTICLE_AXIS
    n_shards = jax.lax.axis_size(pp)
    p_idx = jax.lax.axis_index(pp)
    b, ks = logw_loc.shape
    k_global = ks * n_shards

    # ---- global normalizer pieces (scalars per row — the only replication)
    # stop_gradient BEFORE pmax: the shift is numerics-only (cancels in every
    # ratio) and pmax has no differentiation rule — a symbolically-zero
    # tangent keeps AD from ever asking for one.
    m = jax.lax.pmax(
        jax.lax.stop_gradient(jnp.max(logw_loc, axis=-1, keepdims=True)), pp
    )  # [b, 1]
    w = jnp.exp(logw_loc - m)  # [b, Ks]
    s_loc = jnp.sum(w, axis=-1)  # [b]
    totals = jax.lax.all_gather(s_loc, pp, axis=1, tiled=False)  # [b, P]
    total = jnp.sum(totals, axis=-1, keepdims=True)  # [b, 1]
    offsets = jnp.cumsum(totals, axis=-1) - totals  # [b, P] mass before shard p

    # global ESS = (Σw)² / Σw² (the exp(m) shifts cancel)
    sumsq = jax.lax.psum(jnp.sum(w * w, axis=-1), pp)  # [b]
    ess = (total[:, 0] ** 2) / jnp.maximum(sumsq, 1e-37)
    if ess_threshold >= 1.0:
        do = jnp.ones((b,), bool)  # unconditional resampling, statically
    else:
        do = ess / k_global < ess_threshold  # [b] bool, same on every shard

    # ---- locate each output slot's source shard
    big_u = u_loc * total  # [b, Ks] global mass positions
    src = (
        jnp.sum((big_u[:, :, None] >= offsets[:, None, :]).astype(jnp.int32), -1)
        - 1
    )  # [b, Ks] in [0, P)

    # ---- ring: rotate (logw, x, s) around the particle axis; each step,
    # pick the slots whose ancestor lives on the currently-held shard.
    perm = [(i, (i + 1) % n_shards) for i in range(n_shards)]
    out = jnp.zeros_like(x_loc)
    idx_g = jnp.zeros((b, ks), jnp.int32)
    logw_r, x_r, s_r = logw_loc, x_loc, s_loc[:, None]
    for r in range(n_shards):
        src_shard = (p_idx - r) % n_shards  # whose data we hold this step
        base = jax.lax.dynamic_index_in_dim(
            offsets, src_shard, axis=1, keepdims=True
        )  # [b, 1]
        a, got = _local_lookup(big_u - base, logw_r, x_r, s_r)
        mask = src == src_shard  # [b, Ks]
        out = jnp.where(mask[:, None, :], got, out)
        idx_g = jnp.where(mask, src_shard * ks + a, idx_g)
        if r < n_shards - 1:
            logw_r = jax.lax.ppermute(logw_r, pp, perm)
            x_r = jax.lax.ppermute(x_r, pp, perm)
            s_r = jax.lax.ppermute(s_r, pp, perm)

    x_out = jnp.where(do[:, None, None], out, x_loc)
    logw_out = jnp.where(do[:, None], jnp.zeros_like(logw_loc), logw_loc)
    return x_out, logw_out, do, ess, idx_g
