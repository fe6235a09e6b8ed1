"""Sharded FFBSi backward sweep: a shard_map island over the particle axis.

Round-2 shipped smoothing objectives that *reject* particle meshes: under
GSPMD the backward pass's `take_along_axis` ancestor gathers (and the anchor
categorical) force an all-gather of the full [B, D, K] particle support every
reverse step — exactly the pattern the forward resampling island
(ops/sharded_resampling.py) exists to avoid. This module
closes that gap: the whole reverse sweep runs inside ONE `shard_map` island,
so GSPMD never sees a data-dependent gather over the sharded axis.

Per reverse step, everything stays shard-local except three scalar-sized
collectives per (batch row, backward path):

1. the categorical draw is a *global Gumbel-argmax* — each shard takes the
   max of its local `logits + gumbel` slice, `pmax` finds the global max,
   and `pmin` over `shard·K_loc + argmax_loc` (masked to shards attaining
   the max) picks the lowest global index, reproducing `jnp.argmax`'s
   first-occurrence tie-breaking BIT-EXACTLY against the single-device path
   (both consume the same pre-generated noise, sharded on its K axis);
2. the selected particle/densities are `psum`s of owner-masked local
   gathers — [B, M, Dx] and [B, M] payloads, never [*, K];
3. the backward-weight normalizer is a max-shifted `psum` logsumexp.

Gradient semantics match the unsharded `_make_ffbsi_body`: the discrete
index path is non-differentiable (argmax / integer compares), selected
densities carry their parameter gradients through the masked-psum gathers
(psum's VJP routes the cotangent back to the owner shard), and the
normalizer's max-shift is stop-gradient (numerics-only, cancels in ratios).

Equivalence with the single-device sweep (values AND gradients) is tested on
the 8-virtual-device mesh in tests/test_sharding.py; an HLO assertion checks
the compiled program contains no full-particle all-gather.
"""

from __future__ import annotations

from functools import partial

import jax
import jax.numpy as jnp
from jax.sharding import Mesh, PartitionSpec as P

from psvo_tpu.parallel import context

# Python literal, NOT jnp.int32(...): a module-level concrete jax.Array gets
# hoisted into the jaxpr as a device constant — an extra hidden executable
# argument. Combined with an unused user arg, jax's C++ dispatch fastpath
# then under-supplies buffers on cached re-invocations ("Execution supplied
# 181 buffers but compiled program expected 182", bisected in round 3).
_BIG = 2**31 - 1


def _global_first_argmax(z, p_idx, k_loc, axis_name):
    """argmax over the sharded last axis with jnp.argmax tie-breaking.

    z [..., K_loc]: this shard's slice of the logits (+ noise). Returns
    (gidx [...], aloc [...], own [...]) — the global index of the first
    maximum, the local index on this shard, and the owner mask (True on
    exactly one shard per element)."""
    # the whole selection path is discrete (stop-gradient by construction);
    # pmax also has no differentiation rule — sever AD here explicitly
    z = jax.lax.stop_gradient(z)
    vloc = jnp.max(z, axis=-1)
    aloc = jnp.argmax(z, axis=-1).astype(jnp.int32)
    gmax = jax.lax.pmax(vloc, axis_name)
    # exact float equality is safe: the owner's vloc IS the pmax value
    cand = jnp.where(vloc == gmax, p_idx * k_loc + aloc, _BIG)
    gidx = jax.lax.pmin(cand, axis_name)
    return gidx, aloc, cand == gidx


def _psum_select(val_loc, own, axis_name):
    """Replicate the owner shard's value: psum of the owner-masked local
    gather. Differentiable — the cotangent lands on the owner shard only."""
    return jax.lax.psum(val_loc * own.astype(val_loc.dtype), axis_name)


def _lse_sharded(logits, axis_name):
    """logsumexp over the sharded last axis (max-shifted psum)."""
    m = jax.lax.pmax(
        jax.lax.stop_gradient(jnp.max(logits, axis=-1)), axis_name
    )
    s = jax.lax.psum(jnp.sum(jnp.exp(logits - m[..., None]), axis=-1), axis_name)
    return m + jnp.log(s)


def sharded_anchor(mesh: Mesh, logw_norm, x_last, gum):
    """Draw the M trajectory anchors over the sharded final support.

    logw_norm [B, K] (globally normalized — log_normalize's logsumexp is a
    plain reduction GSPMD psums without gathers), x_last [B, Dx, K],
    gum [B, M, K] pre-generated Gumbel noise (the same array the
    single-device path argmaxes). Returns (x_anchor [B, M, Dx],
    lwn_sel [B, M]) — the anchor particles and their log-pmf.
    """
    pd, pp = context.DATA_AXIS, context.PARTICLE_AXIS

    def island(lwn, x, g):
        p_idx = jax.lax.axis_index(pp)
        k_loc = lwn.shape[-1]
        z = lwn[:, None, :] + g  # [b, M, k_loc]
        _, aloc, own = _global_first_argmax(z, p_idx, k_loc, pp)
        lwn_sel = _psum_select(
            jnp.take_along_axis(lwn[:, None, :], aloc[..., None], axis=-1)[..., 0],
            own, pp,
        )
        x_sel = jnp.swapaxes(
            jnp.take_along_axis(x, aloc[:, None, :], axis=-1), -1, -2
        )  # [b, M, Dx]
        x_anchor = _psum_select(x_sel, own[..., None], pp)
        return x_anchor, lwn_sel

    return jax.shard_map(
        island,
        mesh=mesh,
        in_specs=(P(pd, pp), P(pd, None, pp), P(pd, None, pp)),
        out_specs=(P(pd, None, None), P(pd, None)),
        check_vma=False,
    )(logw_norm, x_last, gum)


def _sup_spec(sup: dict, pd, pp) -> dict:
    """PartitionSpecs for the bulk support-terms pytree ([T', B, ..., K]
    leaves shard their last axis; the constant-tril "chol" [T', B, D, D]
    replicates its trailing dims)."""
    return {
        k: P(None, pd, *(None,) * (v.ndim - 3), None if k == "chol" else pp)
        for k, v in sup.items()
    }


def sharded_ffbsi_sweep(
    mesh: Mesh, query_fn, xs, sup: dict, lwn, lg, gum, x_anchor, logp0, logq0
):
    """The full FFBSi reverse sweep under a ("data", "particle") mesh.

    query_fn(sup_t, x_query) -> [b, M, K_loc]: the pairwise transition
    density's query-side contractions (objectives._pairwise_query_logp closed
    over the SSM) — runs shard-local on the support slice.

    xs [T-1, B, Dx, K], sup (bulk support terms, K-last leaves), lwn/lg
    [T-1, B, K] (normalized forward log-weights / support emission
    densities), gum [T-1, B, M, K], x_anchor [B, M, Dx] (replicated over
    "particle"), logp0/logq0 [B, M] accumulators.

    Returns (x_first [B, M, Dx], logp [B, M], logq [B, M],
    xs_rev [T-1, B, M, Dx]) — identical to the unsharded lax.scan over
    objectives._make_ffbsi_body on the same inputs.
    """
    pd, pp = context.DATA_AXIS, context.PARTICLE_AXIS

    def step_island(x_sup, lwn_t, lg_t, gum_t, x_next, logp, logq, sup_t):
        p_idx = jax.lax.axis_index(pp)
        k_loc = lwn_t.shape[-1]
        pair = query_fn(sup_t, x_next)  # [b, M, k_loc] shard-local
        logits = pair + lwn_t[:, None, :]
        _, aloc, own = _global_first_argmax(logits + gum_t, p_idx, k_loc, pp)
        a3 = aloc[..., None]
        pair_sel = _psum_select(
            jnp.take_along_axis(pair, a3, axis=-1)[..., 0], own, pp
        )
        lwn_sel = _psum_select(
            jnp.take_along_axis(lwn_t, aloc, axis=-1), own, pp
        )
        lg_sel = _psum_select(jnp.take_along_axis(lg_t, aloc, axis=-1), own, pp)
        lse = _lse_sharded(logits, pp)  # [b, M]
        x_sel = jnp.swapaxes(
            jnp.take_along_axis(x_sup, aloc[:, None, :], axis=-1), -1, -2
        )
        x_t = _psum_select(x_sel, own[..., None], pp)  # [b, M, Dx]
        logq = logq + pair_sel + lwn_sel - lse
        logp = logp + pair_sel + lg_sel
        return x_t, logp, logq

    # The lax.scan stays OUTSIDE the island and shard_map wraps ONE reverse
    # step — the same structure as the forward resampling island (one
    # shard_map entry per scan iteration; a whole-sweep island with the scan
    # inside works too and compiles to the same program shape).
    spec_r = P(pd, None, None)  # [B, M, Dx] replicated over particle
    spec_acc = P(pd, None)
    sup_specs = _sup_spec(sup, pd, pp)
    island = jax.shard_map(
        step_island,
        mesh=mesh,
        in_specs=(
            P(pd, None, pp),  # x_sup [B, Dx, K]
            P(pd, pp),  # lwn_t [B, K]
            P(pd, pp),  # lg_t [B, K]
            P(pd, None, pp),  # gum_t [B, M, K]
            spec_r,
            spec_acc,
            spec_acc,
            {k: P(*s[1:]) for k, s in sup_specs.items()},  # per-step slices
        ),
        out_specs=(spec_r, spec_acc, spec_acc),
        check_vma=True,
    )

    def body(carry, inp):
        x_next, logp, logq = carry
        x_sup, sup_t, lwn_t, lg_t, gum_t = inp
        x_t, logp, logq = island(
            x_sup, lwn_t, lg_t, gum_t, x_next, logp, logq, sup_t
        )
        return (x_t, logp, logq), x_t

    (x_first, logp, logq), xs_rev = jax.lax.scan(
        body, (x_anchor, logp0, logq0), (xs, sup, lwn, lg, gum), reverse=True
    )
    return x_first, logp, logq, xs_rev
