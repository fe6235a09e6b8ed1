"""State-space model bundle: proposals q0/q1/q2, transition f, emission g.

Covers the reference's `model.py` (SURVEY.md §2-A, unverified path): the class
that assembles learnable (transformation, distribution) pairs from flags —
initial proposal q0(x_0|y_0), dynamics proposal q1(x_t|x_{t-1}), encoder
proposal q2(x_t|y_t), transition f(x_t|x_{t-1}), emission g(y_t|x_t) — with
bootstrap mode (proposal := f) and two-proposal Gaussian fusion (`use_2_q`,
SURVEY.md §3.2). Reference capability coverage beyond the MLP+diag default:

- exogenous control inputs (`Di`, SURVEY.md §5 flag table): when
  cfg.data.di > 0, the q1/f heads condition on [x_prev, u_t];
- full-covariance heads (`distribution/mvn.py` "diagonal or full"):
  cov_type="tril" on f and/or g — a trainable constant Cholesky factor — or
  cov_type="tril_head" — a STATE-DEPENDENT packed Cholesky from two heads on
  the trunk (proposals stay diagonal: the use_2q precision fusion is
  diagonal math);
- Dirac-delta emissions (`distribution/dirac_delta.py`): emission="dirac"
  observes a deterministic function of state and contributes 0 to weights;
- known-dynamics transitions (SMCConfig.transition="known"): f's mean is the
  TRUE dynamics stepper with a learned noise scale — the learn-proposals-only
  ablation (models/dynamics.py role 2).

Shape: `SSM` is a *static* description (dims, net configs, flags) —
hashable, safe to close over in jit — while all learnable state lives in one
params dict pytree `{"q0","q1","q2","f","g","qb","prior"}`. Every method is a
pure function `(params, arrays) -> arrays`. The `_cm` variants operate on the
channel-major [B, Dx, K] particle layout of the forward filter (see
distributions.mvn_diag_log_prob_cm); the feature-last variants serve the cold
paths (backward smoothing over M≈16 draws, k-step eval, data generation).
"""

from __future__ import annotations

from typing import Any, Optional

import jax
import jax.numpy as jnp

from psvo_tpu import distributions as dist
from psvo_tpu import networks
from psvo_tpu.config import Config, NetConfig
from psvo_tpu.models import dynamics as dyn

Params = dict[str, Any]


class SSM:
    """Static model description; learnable params live in the pytree from `init`."""

    def __init__(self, cfg: Config):
        self.dx = cfg.data.dx
        self.dy = cfg.data.dy
        self.di = cfg.data.di
        self.emission = cfg.data.emission
        self.use_2q = cfg.smc.use_2q
        self.use_bootstrap = cfg.smc.use_bootstrap
        # q_uses_true_X debug flag: the encoder head q2 (and q0) see the true
        # latents, so their input dimension is Dx instead of Dy.
        self.enc_dim = cfg.data.dx if cfg.smc.q_uses_true_x else cfg.data.dy
        # SVO backward proposal RNN option (SURVEY.md §2-A q_b
        # "MLP/RNN-parameterized" [M]): a backward GRU over the observations
        # summarizes y_{t:T} into h_t; q_b conditions on [x_{t+1}, y_t, h_t].
        self.qb_rnn = cfg.smc.qb_rnn
        self.nets = {k: v for k, v in cfg.nets}
        self.bf16_matmuls = cfg.train.bf16_matmuls

        self.transition_known = cfg.smc.transition == "known"
        self.stepper = dyn.make_stepper(cfg.data) if self.transition_known else None
        _full = ("tril", "tril_head")
        # f_tril / g_tril: the head has FULL covariance — either the constant
        # learned Cholesky ("tril") or the state-dependent Cholesky head
        # ("tril_head"); *_tril_head narrows to the latter.
        self.f_tril = (not self.transition_known) and self.nets["f"].cov_type in _full
        self.g_tril = self.nets["g"].cov_type in _full
        self.f_tril_head = (
            not self.transition_known
        ) and self.nets["f"].cov_type == "tril_head"
        self.g_tril_head = self.nets["g"].cov_type == "tril_head"

        for q in ("q0", "q1", "q2", "qb"):
            if self.nets[q].cov_type in _full:
                raise ValueError(
                    f"cov_type={self.nets[q].cov_type!r} is not supported on "
                    f"proposal head {q!r}: the use_2q precision fusion and "
                    "reparameterized draws are diagonal; use it on 'f' or 'g'"
                )
        if self.transition_known and self.nets["f"].cov_type in _full:
            raise ValueError("transition='known' uses a diagonal learned noise scale")
        if self.emission == "poisson" and self.g_tril:
            raise ValueError("poisson emissions have no covariance head")

    # -- init ---------------------------------------------------------------

    def init(self, key: jax.Array) -> Params:
        keys = jax.random.split(key, 7)
        dx, dy, di = self.dx, self.dy, self.di
        if self.emission in ("poisson", "dirac"):
            g_cov = "none"
        else:
            g_cov = self.nets["g"].cov_type

        def head(k, cfg: NetConfig, din, dout, cov=None):
            return networks.init_mlp_head(
                k,
                din,
                dout,
                cfg.hidden,
                cov_type=cov if cov is not None else cfg.cov_type,
                sigma_init=cfg.sigma_init,
                sigma_min=cfg.sigma_min,
            )

        if self.transition_known:
            # true-dynamics mean + learned per-dim noise scale only; with
            # controls (di > 0) an additive learned drift map B_u·u_t on the
            # stepper output, zero-initialized so training starts from the
            # pure known dynamics (SURVEY.md §5 Di flag × transition="known")
            f_cfg = self.nets["f"]
            raw = jnp.log(
                jnp.expm1(jnp.maximum(f_cfg.sigma_init - f_cfg.sigma_min, 1e-6))
            )
            f_params: Params = {"raw_scale": jnp.full((dx,), raw, jnp.float32)}
            if di:
                f_params["ctrl_w"] = jnp.zeros((di, dx), jnp.float32)
        else:
            f_params = head(keys[3], self.nets["f"], dx + di, dx)

        qb_in = dx + dy
        params = {
            "q0": head(keys[0], self.nets["q0"], self.enc_dim, dx),
            "q1": head(keys[1], self.nets["q1"], dx + di, dx),
            "q2": head(keys[2], self.nets["q2"], self.enc_dim, dx),
            "f": f_params,
            "g": head(keys[4], self.nets["g"], dx, dy, cov=g_cov),
            # learned initial prior p(x_0) = N(mu0, diag(scale0^2))
            "prior": {
                "mean": jnp.zeros((dx,), jnp.float32),
                "raw_scale": jnp.zeros((dx,), jnp.float32),  # softplus(0)+min ~ 0.69
            },
        }
        if self.qb_rnn:
            h = self.qb_rnn_dim
            params["qb_rnn"] = networks.init_gru(keys[6], dy, h)
            qb_in += h
        params["qb"] = head(keys[5], self.nets["qb"], qb_in, dx)
        return params

    # -- net application --------------------------------------------------

    def _mean_scale(self, net: Params, cfg: NetConfig, x: jax.Array):
        return networks.mlp_mean_scale(
            net,
            x,
            activation=cfg.activation,
            sigma_min=cfg.sigma_min,
            bf16=self.bf16_matmuls,
        )

    def _mean(self, net: Params, cfg: NetConfig, x: jax.Array):
        """Mean-only head (Poisson log-rate / Dirac / tril mean)."""
        return networks.mlp_mean(
            net, x, activation=cfg.activation, bf16=self.bf16_matmuls
        )

    # -- control-input concat -------------------------------------------------

    def _with_control(self, x: jax.Array, u: Optional[jax.Array]) -> jax.Array:
        """Feature-last concat: x [..., Dx] with u either [B, Di] (broadcast
        over middle axes) or already position-matched [..., Di]."""
        if not self.di:
            return x
        if u is None:
            u = jnp.zeros((*x.shape[:-1], self.di), x.dtype)
        elif u.ndim == x.ndim and u.shape[:-1] == x.shape[:-1]:
            pass  # position-matched (e.g. k-step rollouts over [B, T, ...])
        else:
            u = jnp.broadcast_to(
                u.reshape(u.shape[0], *([1] * (x.ndim - 2)), self.di),
                (*x.shape[:-1], self.di),
            )
        return jnp.concatenate([x, u], axis=-1)

    def _with_control_cm(self, x: jax.Array, u: Optional[jax.Array]) -> jax.Array:
        """Channel-major concat: x [..., Dx, K], u [..., Di] -> [..., Dx+Di, K]
        (leading dims broadcast — the FFBSi bulk support hoist passes
        [T, B, ...])."""
        if not self.di:
            return x
        shape = (*x.shape[:-2], self.di, x.shape[-1])
        if u is None:
            u_b = jnp.zeros(shape, x.dtype)
        else:
            u_b = jnp.broadcast_to(u[..., :, None], shape)
        return jnp.concatenate([x, u_b], axis=-2)

    # -- prior ----------------------------------------------------------------

    def prior_params(self, params: Params):
        p = params["prior"]
        return p["mean"], networks.scale_from_raw(p["raw_scale"], 1e-3)

    def prior_log_prob(self, params: Params, x: jax.Array) -> jax.Array:
        mean, scale = self.prior_params(params)
        return dist.mvn_diag_log_prob(x, mean, scale)

    # -- proposals ------------------------------------------------------------

    def propose_initial(self, params: Params, y0: jax.Array):
        """q0(x_0 | y_0) -> (mean, scale); bootstrap mode proposes from the prior."""
        if self.use_bootstrap:
            mean, scale = self.prior_params(params)
            return jnp.broadcast_to(mean, (*y0.shape[:-1], self.dx)), jnp.broadcast_to(
                scale, (*y0.shape[:-1], self.dx)
            )
        return self._mean_scale(params["q0"], self.nets["q0"], y0)

    def propose(self, params: Params, x_prev: jax.Array, y_t: jax.Array, u=None):
        """q(x_t | x_{t-1}, y_t[, u_t]): q1 ⊗ q2 precision-weighted fusion under
        use_2q, plain q1 otherwise, and the transition f itself in bootstrap
        mode (diagonal f only)."""
        if self.use_bootstrap:
            return self.transition_params(params, x_prev, u)
        m1, s1 = self._mean_scale(
            params["q1"], self.nets["q1"], self._with_control(x_prev, u)
        )
        if not self.use_2q:
            return m1, s1
        m2, s2 = self._mean_scale(params["q2"], self.nets["q2"], y_t)
        return dist.mvn_product(m1, s1, m2, s2)

    @property
    def qb_rnn_dim(self) -> int:
        """GRU state width for the qb RNN option: the qb trunk's first
        hidden size (one knob fewer; same order as the MLP capacity)."""
        return self.nets["qb"].hidden[0]

    def backward_rnn_summaries(self, params: Params, ys_tm: jax.Array):
        """h_t = GRU(h_{t+1}, y_t) run BACKWARD over the observations:
        h_t summarizes y_{t:T}. ys_tm [T, B, Dy] -> [T, B, H].

        Shape note: the recurrence is a [B, ·]-sized reverse lax.scan —
        K- and M-independent, so its cost is negligible next to the
        particle math; the per-(M-path) work stays in the bulk MLP heads.
        """
        gru = params["qb_rnn"]
        b = ys_tm.shape[1]
        h_last = jnp.zeros((b, self.qb_rnn_dim), jnp.float32)

        def body(h, y_t):
            h = networks.gru_step(gru, h, y_t)
            return h, h

        _, hs = jax.lax.scan(body, h_last, ys_tm, reverse=True)
        return hs  # [T, B, H]; hs[t] has consumed y_{t:T}

    def backward_propose(
        self, params: Params, x_next: jax.Array, y_t: jax.Array, h_t=None
    ):
        """SVO's learned backward proposal q_b(x_t | x_{t+1}, y_t)
        (SURVEY.md §3.3) — with the RNN option (smc.qb_rnn) additionally
        conditioned on the backward-GRU summary h_t of y_{t:T}."""
        parts = [x_next, jnp.broadcast_to(y_t, (*x_next.shape[:-1], self.dy))]
        if self.qb_rnn:
            if h_t is None:
                raise ValueError(
                    "smc.qb_rnn=True: backward_propose needs the h_t summary "
                    "(ssm.backward_rnn_summaries)"
                )
            parts.append(
                jnp.broadcast_to(h_t, (*x_next.shape[:-1], self.qb_rnn_dim))
            )
        inp = jnp.concatenate(parts, axis=-1)
        return self._mean_scale(params["qb"], self.nets["qb"], inp)

    # -- channel-major variants (the forward filter's hot path) ---------------

    def _mean_scale_cm(self, net: Params, cfg: NetConfig, x: jax.Array):
        return networks.mlp_mean_scale_cm(
            net,
            x,
            activation=cfg.activation,
            sigma_min=cfg.sigma_min,
            bf16=self.bf16_matmuls,
        )

    def prior_log_prob_cm(self, params: Params, x: jax.Array) -> jax.Array:
        """x [..., Dx, K] -> [..., K]."""
        mean, scale = self.prior_params(params)
        return dist.mvn_diag_log_prob_cm(x, mean[:, None], scale[:, None])

    def _known_drift(self, params: Params, mean: jax.Array, u) -> jax.Array:
        """Additive control drift B_u·u_t on a known-dynamics mean [..., Dx];
        u is [B, Di] (broadcast over middle axes) or position-matched
        [..., Di] (k-step rollouts) — mirror of _with_control's shapes."""
        if not self.di or u is None:
            return mean
        drift = u @ params["f"]["ctrl_w"]  # [..., Dx]
        if not (drift.ndim == mean.ndim and drift.shape[:-1] == mean.shape[:-1]):
            drift = drift.reshape(
                drift.shape[0], *([1] * (mean.ndim - 2)), self.dx
            )
        return mean + drift

    def transition_params_cm(self, params: Params, x_prev: jax.Array, u=None):
        """Diagonal transition: x_prev [..., Dx, K] -> (mean, scale) [..., Dx, K]."""
        if self.transition_known:
            mean = self.stepper.step(x_prev, axis=-2)
            if self.di and u is not None:
                mean = mean + (u @ params["f"]["ctrl_w"])[..., :, None]
            scale = networks.scale_from_raw(
                params["f"]["raw_scale"], self.nets["f"].sigma_min
            )
            return mean, jnp.broadcast_to(scale[:, None], mean.shape)
        return self._mean_scale_cm(
            params["f"], self.nets["f"], self._with_control_cm(x_prev, u)
        )

    def transition_full_cm(self, params: Params, x_prev: jax.Array, u=None):
        """Constant full-covariance transition (cov_type='tril' on f):
        -> (mean [..., Dx, K], chol [Dx, Dx])."""
        mean = networks.mlp_mean_cm(
            params["f"],
            self._with_control_cm(x_prev, u),
            activation=self.nets["f"].activation,
            bf16=self.bf16_matmuls,
        )
        chol = networks.tril_from_raw(params["f"]["raw_tril"], self.nets["f"].sigma_min)
        return mean, chol

    def transition_tril_cm(self, params: Params, x_prev: jax.Array, u=None):
        """State-dependent full-covariance transition (cov_type='tril_head'
        on f): -> (mean, diag [..., Dx, K], off [..., Dx(Dx-1)/2, K])."""
        return networks.mlp_mean_tril_cm(
            params["f"],
            self._with_control_cm(x_prev, u),
            activation=self.nets["f"].activation,
            sigma_min=self.nets["f"].sigma_min,
            bf16=self.bf16_matmuls,
        )

    def transition_log_prob_cm(
        self, params: Params, x_prev: jax.Array, x: jax.Array, u=None
    ) -> jax.Array:
        """log f(x | x_prev[, u]) in channel-major layout -> [..., K]."""
        if self.f_tril_head:
            mean, diag, off = self.transition_tril_cm(params, x_prev, u)
            return dist.mvn_tril_log_prob_cm(x, mean, diag, off)
        if self.f_tril:
            mean, chol = self.transition_full_cm(params, x_prev, u)
            return dist.mvn_full_log_prob_cm(x, mean, chol)
        mean, scale = self.transition_params_cm(params, x_prev, u)
        return dist.mvn_diag_log_prob_cm(x, mean, scale)

    def q2_mean_scale(self, params: Params, enc: jax.Array):
        """Encoder proposal q2(x_t | y_t) parameters, feature-last.

        q2 depends only on the observation, so the filter evaluates it for
        ALL T steps in one batched call OUTSIDE the scan — the per-step MLP
        chain on [B, E] was pure launch overhead inside a latency-bound scan.
        """
        return self._mean_scale(params["q2"], self.nets["q2"], enc)

    def propose_cm(
        self, params: Params, x_prev: jax.Array, y_t: jax.Array, u=None, q2_ms=None
    ):
        """Diagonal proposal in channel-major layout (bootstrap: diagonal f).

        q2_ms optionally supplies precomputed q2 (mean, scale) [B, Dx]
        (see q2_mean_scale); y_t is consulted only when it is absent.
        """
        if self.use_bootstrap:
            return self.transition_params_cm(params, x_prev, u)
        m1, s1 = self._mean_scale_cm(
            params["q1"], self.nets["q1"], self._with_control_cm(x_prev, u)
        )
        if not self.use_2q:
            return m1, s1
        m2, s2 = q2_ms if q2_ms is not None else self.q2_mean_scale(params, y_t)
        return dist.mvn_product(m1, s1, m2[..., None], s2[..., None])

    def step_heads_cm(
        self, params: Params, x_prev: jax.Array, y_t: jax.Array, u=None, q2_ms=None
    ):
        """All per-step diagonal conditionals on x_prev in one go:
        x_prev [B, Dx, K], y_t [B, E] -> (mean_q, scale_q, mean_f, scale_f),
        each [B, Dx, K]. Diagonal-f configs only — the smc body routes tril
        transitions through propose_cm/transition_log_prob_cm instead.
        q2_ms: precomputed q2 (mean, scale) [B, Dx] (see q2_mean_scale).

        q1 and f consume the SAME input, so when their architectures match
        (the default) they evaluate as ONE stacked vmapped MLP — XLA emits a
        single batched matmul chain, halving the per-step MLP op count inside
        the sequential scan. Also returns the
        transition parameters so the incremental weight α_t never re-runs the
        f network. The encoder head q2 runs feature-last on the [B, E]
        observation (one row per trajectory — no K broadcast materializes)
        and joins the fusion as [B, Dx, 1].
        """
        if self.use_bootstrap:
            mean_f, scale_f = self.transition_params_cm(params, x_prev, u)
            return mean_f, scale_f, mean_f, scale_f

        q1_cfg, f_cfg = self.nets["q1"], self.nets["f"]
        stackable = (
            not self.transition_known
            and q1_cfg.hidden == f_cfg.hidden
            and q1_cfg.activation == f_cfg.activation
            and q1_cfg.cov_type == f_cfg.cov_type == "const"
            and q1_cfg.sigma_min == f_cfg.sigma_min
        )
        x_in = self._with_control_cm(x_prev, u)
        if stackable:
            stacked = jax.tree_util.tree_map(
                lambda a, b: jnp.stack([a, b]), params["q1"], params["f"]
            )
            means, scales = jax.vmap(
                lambda net: networks.mlp_mean_scale_cm(
                    net,
                    x_in,
                    activation=q1_cfg.activation,
                    sigma_min=q1_cfg.sigma_min,
                    bf16=self.bf16_matmuls,
                )
            )(stacked)
            m1, s1 = means[0], scales[0]
            mean_f, scale_f = means[1], scales[1]
        else:
            m1, s1 = self._mean_scale_cm(params["q1"], q1_cfg, x_in)
            mean_f, scale_f = self.transition_params_cm(params, x_prev, u)

        if self.use_2q:
            m2, s2 = q2_ms if q2_ms is not None else self.q2_mean_scale(params, y_t)
            mean_q, scale_q = dist.mvn_product(
                m1, s1, m2[..., None], s2[..., None]
            )
        else:
            mean_q, scale_q = m1, s1
        return mean_q, scale_q, mean_f, scale_f

    def emission_log_prob_cm(
        self, params: Params, x: jax.Array, y: jax.Array
    ) -> jax.Array:
        """x [B, Dx, K], y [B, Dy] -> [B, K]."""
        g_cfg = self.nets["g"]
        if self.emission == "dirac":
            # deterministic observation map (reference dirac_delta semantics):
            # constant density, contributes 0 to the weights
            return jnp.zeros((*x.shape[:-2], x.shape[-1]), x.dtype)
        if self.emission == "poisson":
            log_rate = networks.mlp_mean_cm(
                params["g"], x, activation=g_cfg.activation, bf16=self.bf16_matmuls
            )
            return dist.poisson_log_prob_cm(y[..., :, None], log_rate)
        if self.g_tril_head:
            mean, diag, off = networks.mlp_mean_tril_cm(
                params["g"], x, activation=g_cfg.activation,
                sigma_min=g_cfg.sigma_min, bf16=self.bf16_matmuls,
            )
            return dist.mvn_tril_log_prob_cm(y[..., :, None], mean, diag, off)
        if self.g_tril:
            mean = networks.mlp_mean_cm(
                params["g"], x, activation=g_cfg.activation, bf16=self.bf16_matmuls
            )
            chol = networks.tril_from_raw(params["g"]["raw_tril"], g_cfg.sigma_min)
            return dist.mvn_full_log_prob_cm(y[..., :, None], mean, chol)
        mean, scale = self._mean_scale_cm(params["g"], g_cfg, x)
        return dist.mvn_diag_log_prob_cm(y[..., :, None], mean, scale)

    # -- transition / emission (feature-last: backward smoothing, eval) --------

    def transition_params(self, params: Params, x_prev: jax.Array, u=None):
        """Diagonal transition -> (mean, scale), feature-last."""
        if self.transition_known:
            mean = self._known_drift(params, self.stepper.step(x_prev), u)
            scale = networks.scale_from_raw(
                params["f"]["raw_scale"], self.nets["f"].sigma_min
            )
            return mean, jnp.broadcast_to(scale, mean.shape)
        return self._mean_scale(
            params["f"], self.nets["f"], self._with_control(x_prev, u)
        )

    def transition_mean(self, params: Params, x_prev: jax.Array, u=None) -> jax.Array:
        """Mean next state — k-step prediction rollouts (SURVEY.md §3.4)."""
        if self.transition_known:
            return self._known_drift(params, self.stepper.step(x_prev), u)
        if self.f_tril:
            return networks.mlp_mean(
                params["f"],
                self._with_control(x_prev, u),
                activation=self.nets["f"].activation,
                bf16=self.bf16_matmuls,
            )
        return self.transition_params(params, x_prev, u)[0]

    def transition_log_prob(
        self, params: Params, x_prev: jax.Array, x: jax.Array, u=None
    ) -> jax.Array:
        if self.f_tril_head:
            mean, chol = networks.mlp_mean_tril(
                params["f"],
                self._with_control(x_prev, u),
                activation=self.nets["f"].activation,
                sigma_min=self.nets["f"].sigma_min,
                bf16=self.bf16_matmuls,
            )
            return dist.mvn_full_log_prob(x, mean, chol)
        if self.f_tril:
            mean = networks.mlp_mean(
                params["f"],
                self._with_control(x_prev, u),
                activation=self.nets["f"].activation,
                bf16=self.bf16_matmuls,
            )
            chol = networks.tril_from_raw(
                params["f"]["raw_tril"], self.nets["f"].sigma_min
            )
            return dist.mvn_full_log_prob(x, mean, chol)
        mean, scale = self.transition_params(params, x_prev, u)
        return dist.mvn_diag_log_prob(x, mean, scale)

    def emission_log_prob(self, params: Params, x: jax.Array, y: jax.Array) -> jax.Array:
        if self.emission == "dirac":
            return jnp.zeros(x.shape[:-1], x.dtype)
        if self.emission == "poisson":
            log_rate = self._mean(params["g"], self.nets["g"], x)
            return dist.poisson_log_prob(y, log_rate)
        if self.g_tril_head:
            mean, chol = networks.mlp_mean_tril(
                params["g"], x, activation=self.nets["g"].activation,
                sigma_min=self.nets["g"].sigma_min, bf16=self.bf16_matmuls,
            )
            return dist.mvn_full_log_prob(y, mean, chol)
        if self.g_tril:
            mean = self._mean(params["g"], self.nets["g"], x)
            chol = networks.tril_from_raw(
                params["g"]["raw_tril"], self.nets["g"].sigma_min
            )
            return dist.mvn_full_log_prob(y, mean, chol)
        mean, scale = self._mean_scale(params["g"], self.nets["g"], x)
        return dist.mvn_diag_log_prob(y, mean, scale)

    def emission_mean(self, params: Params, x: jax.Array) -> jax.Array:
        """Mean observation ŷ(x) — used by k-step prediction R² (SURVEY.md §3.4)."""
        if self.emission == "poisson":
            return jnp.exp(self._mean(params["g"], self.nets["g"], x))
        if self.emission == "dirac" or self.g_tril:
            return self._mean(params["g"], self.nets["g"], x)
        return self._mean_scale(params["g"], self.nets["g"], x)[0]


def init_ssm(cfg: Config, key: jax.Array) -> tuple[SSM, Params]:
    ssm = SSM(cfg)
    return ssm, ssm.init(key)
