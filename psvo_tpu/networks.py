"""MLP heads as plain parameter pytrees (reference `transformation/MLP.py`).

The reference parameterizes every conditional (proposals q0/q1/q2, transition
f, emission g) as an MLP producing a mean, with the covariance either a
trainable state-independent diagonal or a second head (SURVEY.md §2-A,
`distribution/mvn.py` + `transformation/MLP.py`, unverified paths).

Here a network is a dict pytree (`{"layers": [(W, b), ...], "mean": (W, b),
"raw_scale": ...}`) plus pure apply functions — no framework module system, so
the same pytree feeds the apply functions and optax without adapters. All
leading axes broadcast: apply flattens [..., Din] -> [N, Din] around the
matmul chain so batch*particle rows form one large matmul.
"""

from __future__ import annotations

from collections.abc import Sequence
from functools import partial
from typing import Any

import jax
import jax.numpy as jnp

Params = dict[str, Any]

_ACTIVATIONS = {
    "relu": jax.nn.relu,
    "tanh": jnp.tanh,
    "gelu": jax.nn.gelu,
    "softplus": jax.nn.softplus,
}


def activation_fn(name: str):
    return _ACTIVATIONS[name]


def _init_dense(key: jax.Array, din: int, dout: int) -> tuple[jax.Array, jax.Array]:
    """Glorot-uniform weight + zero bias, float32."""
    limit = jnp.sqrt(6.0 / (din + dout))
    w = jax.random.uniform(key, (din, dout), jnp.float32, -limit, limit)
    return w, jnp.zeros((dout,), jnp.float32)


def init_mlp_head(
    key: jax.Array,
    din: int,
    dout: int,
    hidden: Sequence[int],
    *,
    cov_type: str = "const",
    sigma_init: float = 1.0,
    sigma_min: float = 1e-3,
) -> Params:
    """Initialize an MLP that maps inputs to (mean, scale) of a diagonal Gaussian.

    cov_type:
      "const" — scale is a trainable per-dimension vector, state-independent
                (the reference mvn default with sigma_init/sigma_min floors).
      "head"  — scale is a second linear head on the last hidden layer.
      "none"  — mean-only network (Dirac / Poisson log-rate heads).
    """
    sizes = [din, *hidden]
    keys = jax.random.split(key, len(sizes) + 1)
    layers = [
        _init_dense(keys[i], sizes[i], sizes[i + 1]) for i in range(len(sizes) - 1)
    ]
    params: Params = {
        "layers": layers,
        "mean": _init_dense(keys[-2], sizes[-1], dout),
    }
    if cov_type == "const":
        # softplus(raw) + sigma_min == sigma_init at init.
        raw = jnp.log(jnp.expm1(jnp.maximum(sigma_init - sigma_min, 1e-6)))
        params["raw_scale"] = jnp.full((dout,), raw, jnp.float32)
    elif cov_type == "tril":
        # trainable state-independent FULL covariance via its Cholesky factor:
        # diag = softplus(raw_diag) + sigma_min (floored, sigma_init at init),
        # strict lower triangle free (zero at init -> starts diagonal).
        raw = jnp.log(jnp.expm1(jnp.maximum(sigma_init - sigma_min, 1e-6)))
        params["raw_tril"] = {
            "diag": jnp.full((dout,), raw, jnp.float32),
            "off": jnp.zeros((dout * (dout - 1) // 2,), jnp.float32),
        }
    elif cov_type == "tril_head":
        # STATE-DEPENDENT full covariance: two linear heads on the trunk
        # emit the packed Cholesky factor per input — floored-softplus
        # diagonal [dout], free strict-lower entries [dout(dout-1)/2].
        # Near-zero weights + sigma_init bias: starts ≈ the constant
        # diagonal, like every other cov head.
        raw = jnp.log(jnp.expm1(jnp.maximum(sigma_init - sigma_min, 1e-6)))
        kd, ko = jax.random.split(keys[-1])
        wd, bd = _init_dense(kd, sizes[-1], dout)
        params["tril_diag_head"] = (wd * 0.01, bd + raw)
        n_off = dout * (dout - 1) // 2
        wo, bo = _init_dense(ko, sizes[-1], max(n_off, 1))
        params["tril_off_head"] = (wo[:, :n_off] * 0.01, bo[:n_off])
    elif cov_type == "head":
        raw = jnp.log(jnp.expm1(jnp.maximum(sigma_init - sigma_min, 1e-6)))
        w, b = _init_dense(keys[-1], sizes[-1], dout)
        params["scale_head"] = (w * 0.01, b + raw)  # start near sigma_init
    elif cov_type != "none":
        raise ValueError(f"unknown cov_type: {cov_type!r}")
    return params


def init_gru(key: jax.Array, din: int, dh: int) -> Params:
    """GRU cell parameters: update z, reset r, candidate h̃ gates, each a
    dense map on [x; h]. Used by the SVO backward proposal's RNN option
    (SURVEY.md §2-A tags the reference's q_b as "MLP/RNN-parameterized"):
    a backward recurrence over observations summarizes y_{t:T} into h_t.
    """
    kz, kr, kh = jax.random.split(key, 3)
    return {
        "z": _init_dense(kz, din + dh, dh),
        "r": _init_dense(kr, din + dh, dh),
        "h": _init_dense(kh, din + dh, dh),
    }


def gru_step(params: Params, h: jax.Array, x: jax.Array) -> jax.Array:
    """One GRU update h' = (1−z)·h + z·h̃. h [..., H], x [..., Din]."""
    hx = jnp.concatenate([x, h], axis=-1)
    wz, bz = params["z"]
    wr, br = params["r"]
    wh, bh = params["h"]
    z = jax.nn.sigmoid(hx @ wz + bz)
    r = jax.nn.sigmoid(hx @ wr + br)
    h_cand = jnp.tanh(jnp.concatenate([x, r * h], axis=-1) @ wh + bh)
    return (1.0 - z) * h + z * h_cand


def scale_from_raw(raw: jax.Array, sigma_min: float) -> jax.Array:
    """softplus + floor, the reference's sigma_min clamp (SURVEY.md §2-A mvn)."""
    return jax.nn.softplus(raw) + sigma_min


def tril_from_raw(raw_tril: dict, sigma_min: float) -> jax.Array:
    """Assemble the [D, D] lower-triangular Cholesky factor from its packed
    parameterization (cov_type="tril"): floored-softplus diagonal, free
    strict-lower entries."""
    d = raw_tril["diag"].shape[0]
    chol = jnp.diag(scale_from_raw(raw_tril["diag"], sigma_min))
    if d > 1:
        rows, cols = jnp.tril_indices(d, k=-1)
        chol = chol.at[rows, cols].set(raw_tril["off"])
    return chol


def _dense(h: jax.Array, w: jax.Array, b: jax.Array, bf16: bool) -> jax.Array:
    """One dense layer; bf16=True runs the matmul in bfloat16 operands with
    float32 accumulation — activations/bias stay f32 so the
    log-density numerics downstream keep their mantissa."""
    if bf16:
        out = jax.lax.dot_general(
            h.astype(jnp.bfloat16),
            w.astype(jnp.bfloat16),
            dimension_numbers=(((h.ndim - 1,), (0,)), ((), ())),
            preferred_element_type=jnp.float32,
        )
        return out + b
    return h @ w + b


def mlp_features(
    params: Params, x: jax.Array, activation: str = "relu", bf16: bool = False
) -> jax.Array:
    """Hidden trunk: chain of dense+activation over the last axis."""
    act = _ACTIVATIONS[activation]
    h = x
    for w, b in params["layers"]:
        h = act(_dense(h, w, b, bf16))
    return h


def mlp_mean(
    params: Params, x: jax.Array, activation: str = "relu", bf16: bool = False
) -> jax.Array:
    h = mlp_features(params, x, activation, bf16)
    w, b = params["mean"]
    return _dense(h, w, b, bf16)


def mlp_mean_scale(
    params: Params,
    x: jax.Array,
    activation: str = "relu",
    sigma_min: float = 1e-3,
    bf16: bool = False,
) -> tuple[jax.Array, jax.Array]:
    """Return (mean, scale) with the scale floored at sigma_min."""
    h = mlp_features(params, x, activation, bf16)
    w, b = params["mean"]
    mean = _dense(h, w, b, bf16)
    if "raw_scale" in params:
        scale = jnp.broadcast_to(
            scale_from_raw(params["raw_scale"], sigma_min), mean.shape
        )
    elif "scale_head" in params:
        ws, bs = params["scale_head"]
        scale = scale_from_raw(h @ ws + bs, sigma_min)
    else:
        raise ValueError("network has no scale parameterization (cov_type='none')")
    return mean, scale


def mlp_mean_tril(
    params: Params,
    x: jax.Array,
    activation: str = "relu",
    sigma_min: float = 1e-3,
    bf16: bool = False,
) -> tuple[jax.Array, jax.Array]:
    """State-dependent full covariance (cov_type="tril_head"), feature-last:
    -> (mean [..., D], chol [..., D, D]) with floored-softplus diagonal and
    free strict-lower entries (row-major packing, matching
    jnp.tril_indices(k=-1))."""
    h = mlp_features(params, x, activation, bf16)
    w, b = params["mean"]
    mean = _dense(h, w, b, bf16)
    d = mean.shape[-1]
    wd, bd = params["tril_diag_head"]
    diag = scale_from_raw(_dense(h, wd, bd, bf16), sigma_min)  # [..., D]
    chol = jnp.zeros((*mean.shape, d), mean.dtype)
    ii = jnp.arange(d)
    chol = chol.at[..., ii, ii].set(diag)
    if d > 1:
        wo, bo = params["tril_off_head"]
        off = _dense(h, wo, bo, bf16)  # [..., D(D-1)/2]
        rows, cols = jnp.tril_indices(d, k=-1)
        chol = chol.at[..., rows, cols].set(off)
    return mean, chol


# ---------------------------------------------------------------------------
# Channel-major apply: features on axis -2, particles on the last axis.
#
# The forward filter keeps particle tensors as [B, D, K] (see
# distributions.mvn_diag_log_prob_cm for the layout rationale), so the dense
# chain contracts the -2 axis: out[..., e, k] = Σ_d w[d, e] · h[..., d, k].
# Per batch row this is the [E, D] × [D, K] product with K as the wide
# dimension; the tiny feature dim is never the minor axis of the chain.
# ---------------------------------------------------------------------------


def _dense_cm(h: jax.Array, w: jax.Array, b: jax.Array, bf16: bool) -> jax.Array:
    """One dense layer over the -2 (channel) axis: [..., Din, K] -> [..., Dout, K]."""
    if bf16:
        out = jnp.einsum(
            "de,...dk->...ek",
            w.astype(jnp.bfloat16),
            h.astype(jnp.bfloat16),
            preferred_element_type=jnp.float32,
        )
    else:
        out = jnp.einsum("de,...dk->...ek", w, h, preferred_element_type=jnp.float32)
    return out + b[..., :, None]


def mlp_features_cm(
    params: Params, x: jax.Array, activation: str = "relu", bf16: bool = False
) -> jax.Array:
    act = _ACTIVATIONS[activation]
    h = x
    for w, b in params["layers"]:
        h = act(_dense_cm(h, w, b, bf16))
    return h


def mlp_mean_cm(
    params: Params, x: jax.Array, activation: str = "relu", bf16: bool = False
) -> jax.Array:
    h = mlp_features_cm(params, x, activation, bf16)
    w, b = params["mean"]
    return _dense_cm(h, w, b, bf16)


def mlp_mean_scale_cm(
    params: Params,
    x: jax.Array,
    activation: str = "relu",
    sigma_min: float = 1e-3,
    bf16: bool = False,
) -> tuple[jax.Array, jax.Array]:
    """Channel-major (mean, scale): [..., Din, K] -> 2× [..., Dout, K]."""
    h = mlp_features_cm(params, x, activation, bf16)
    w, b = params["mean"]
    mean = _dense_cm(h, w, b, bf16)
    if "raw_scale" in params:
        scale = jnp.broadcast_to(
            scale_from_raw(params["raw_scale"], sigma_min)[..., :, None], mean.shape
        )
    elif "scale_head" in params:
        ws, bs = params["scale_head"]
        scale = scale_from_raw(_dense_cm(h, ws, bs, bf16), sigma_min)
    else:
        raise ValueError("network has no scale parameterization (cov_type='none')")
    return mean, scale


def mlp_mean_tril_cm(
    params: Params,
    x: jax.Array,
    activation: str = "relu",
    sigma_min: float = 1e-3,
    bf16: bool = False,
) -> tuple[jax.Array, jax.Array, jax.Array]:
    """Channel-major tril_head: [..., Din, K] -> (mean [..., D, K],
    diag [..., D, K], off [..., D(D-1)/2, K]) — the Cholesky factor stays
    PACKED as channel tensors (never a [..., D, D, K] blowup); consumers
    unroll the tiny-D substitution (distributions.mvn_tril_log_prob_cm)."""
    h = mlp_features_cm(params, x, activation, bf16)
    w, b = params["mean"]
    mean = _dense_cm(h, w, b, bf16)
    wd, bd = params["tril_diag_head"]
    diag = scale_from_raw(_dense_cm(h, wd, bd, bf16), sigma_min)
    d = mean.shape[-2]
    if d > 1:
        wo, bo = params["tril_off_head"]
        off = _dense_cm(h, wo, bo, bf16)
    else:
        off = jnp.zeros((*mean.shape[:-2], 0, mean.shape[-1]), mean.dtype)
    return mean, diag, off


def count_params(params) -> int:
    return sum(p.size for p in jax.tree_util.tree_leaves(params))
