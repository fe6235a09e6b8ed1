"""Training loop: optax Adam + global-norm clipping, jitted train step, eval.

Covers the reference's `trainer.py` (SURVEY.md §2-A/§3.1, unverified path):
Adam with `clip_by_global_norm`, epochs over shuffled minibatches of
trajectories, periodic train/test ELBO eval, early stopping on patience, and
k-step-ahead prediction MSE/R² against held-out observations (§3.4).

Shape: the reference's `sess.run(train_op)` hot loop becomes ONE
jitted `train_step` (value_and_grad over the whole SMC scan + optax update);
everything outside it is cold Python. Eval is a second jitted function. Data
stays on-device between steps; minibatch selection is a device-side gather
with a host-provided index array.
"""

from __future__ import annotations

import time
from dataclasses import dataclass
from functools import partial
from typing import Any, Callable, Optional

import jax
import jax.numpy as jnp
import numpy as np
import optax

from psvo_tpu.utils.rng import run_key
from psvo_tpu.config import Config
from psvo_tpu.distributions import log_normalize
from psvo_tpu.models.ssm import SSM
from psvo_tpu.objectives import make_objective
from psvo_tpu.smc import forward_filter


def make_optimizer(cfg: Config) -> optax.GradientTransformation:
    """Adam + global-norm clip, hardened against weight-degeneracy spikes.

    When the ESS collapses early in training, a handful of particles carry
    log-weights with |α| ~ 1e5-1e6 and occasional steps produce inf/overflow
    gradients (measured: grad norms to 1e14 at K=1024 on FHN). Clipping alone
    turns an inf norm into NaN params, so non-finite updates are skipped
    entirely (`apply_if_finite`) — the estimator is untouched; a bad draw
    just doesn't update.
    """
    if cfg.train.lr_schedule == "cosine":
        lr = optax.cosine_decay_schedule(
            cfg.train.lr, decay_steps=max(cfg.train.n_steps, 1), alpha=0.1
        )
    else:
        lr = cfg.train.lr
    return optax.apply_if_finite(
        optax.chain(
            # a floored log-density (distributions._MIN_LOGP) zeroes its
            # cotangent via select, but 0·inf upstream still yields NaN for
            # the offending leaves — zero those out so the finite leaves keep
            # training instead of every update being skipped
            optax.zero_nans(),
            optax.clip_by_global_norm(cfg.train.clip_norm),
            optax.adam(lr),
        ),
        max_consecutive_errors=100,
    )


def make_train_step(ssm: SSM, cfg: Config, optimizer) -> Callable:
    """One jitted optimization step over a minibatch of trajectories.

    With cfg.train.debug_checks the step runs under `checkify` float checks
    (SURVEY.md §5 sanitizers row: "checkify for NaN/OOB guards in debug
    builds"): the step reports WHERE the first non-finite value was produced
    — unlike --debug-nans, which needs op-by-op eager re-execution. The
    error pytree rides the metrics dict
    (`metrics["checkify_err"]`); the Trainer throws it after each step, and
    direct callers can `checkify.check_error(metrics.pop("checkify_err"))`.
    """
    objective = make_objective(ssm, cfg)

    def _step(params, opt_state, key, batch, encoder_inputs, controls):
        def loss_fn(p):
            with jax.named_scope("objective"):
                out = objective(p, key, batch, encoder_inputs, controls)
            return out.loss, out.metrics

        (loss, metrics), grads = jax.value_and_grad(loss_fn, has_aux=True)(params)
        with jax.named_scope("optimizer"):
            updates, opt_state = optimizer.update(grads, opt_state, params)
            params = optax.apply_updates(params, updates)
        metrics = dict(metrics)
        metrics["loss"] = loss
        metrics["grad_norm"] = optax.global_norm(grads)
        return params, opt_state, metrics

    n_per_call = max(int(cfg.train.steps_per_call), 1)
    if n_per_call > 1:
        # N steps per jitted call, amortizing the host's per-call dispatch.
        # `keys` is the [N] stack of the SAME per-step split chain the N=1
        # path walks, so trajectories are bit-identical across
        # steps_per_call values (tested).
        def _step_n(params, opt_state, keys, batches, encoder_inputs, controls):
            def body(carry, inp):
                p, s = carry
                k_i, b_i, e_i, c_i = inp
                p, s, m = _step(p, s, k_i, b_i, e_i, c_i)
                return (p, s), m

            (params, opt_state), ms = jax.lax.scan(
                body, (params, opt_state), (keys, batches, encoder_inputs, controls)
            )
            # eval-cadence consumers read the LAST step's train metrics
            metrics = jax.tree_util.tree_map(lambda a: a[-1], ms)
            return params, opt_state, metrics

        inner = _step_n
    else:
        inner = _step

    if cfg.train.debug_checks:
        from jax.experimental import checkify

        checked = checkify.checkify(inner, errors=checkify.float_checks)

        @jax.jit
        def train_step(
            params, opt_state, key, batch, encoder_inputs=None, controls=None
        ):
            err, (params, opt_state, metrics) = checked(
                params, opt_state, key, batch, encoder_inputs, controls
            )
            metrics["checkify_err"] = err
            return params, opt_state, metrics

        return train_step

    @jax.jit
    def train_step(params, opt_state, key, batch, encoder_inputs=None, controls=None):
        return inner(params, opt_state, key, batch, encoder_inputs, controls)

    return train_step


# ---------------------------------------------------------------------------
# Evaluation: test ELBO + k-step-ahead prediction R² (reference §3.4)
# ---------------------------------------------------------------------------


def filtered_means(fwd) -> jax.Array:
    """Posterior filtering means: [B, T, Dx].

    The scan emits them directly (FilterResult.filtered_means — O(T·B·Dx)),
    so no particle cache is needed; the cached-particle path remains as a
    fallback for hand-built FilterResults."""
    if fwd.filtered_means is not None:
        return jnp.swapaxes(fwd.filtered_means, 0, 1)
    logw_norm, _ = log_normalize(fwd.logws, axis=-1)  # [T, B, K]
    means = jnp.einsum("tbk,tbdk->tbd", jnp.exp(logw_norm), fwd.xs)
    return jnp.swapaxes(means, 0, 1)


def k_step_predictions(
    ssm: SSM, params, filt_means: jax.Array, k_max: int, controls=None
):
    """Roll the mean dynamics k steps from each filtered mean and emit.

    Returns ŷ [k_max, B, T, Dy]: ŷ[k-1, :, t] predicts y_{t+k} (valid for
    t + k < T; the caller masks). Deterministic mean rollout, matching the
    reference's evaluation (SURVEY.md §3.4). With control inputs, rollout
    step j from time t consumes the (known) future control u_{t+j}.
    """
    b, t_steps, _ = filt_means.shape
    if ssm.di and controls is not None:
        # ctrl_shift[j-1][:, t] = u_{t+j} (zero past the horizon; masked anyway)
        ctrl_shift = jnp.stack(
            [
                jnp.pad(controls[:, j:], ((0, 0), (0, j), (0, 0)))
                for j in range(1, k_max + 1)
            ]
        )  # [k_max, B, T, Di]
    else:
        ctrl_shift = jnp.zeros((k_max, b, t_steps, ssm.di), jnp.float32)

    def roll(x, u_j):
        mean = ssm.transition_mean(params, x, u_j)
        return mean, ssm.emission_mean(params, mean)

    _, preds = jax.lax.scan(roll, filt_means, ctrl_shift)
    return preds  # [k_max, B, T, Dy]


def make_eval_step(ssm: SSM, cfg: Config) -> Callable:
    objective = make_objective(ssm, cfg)
    k_max = cfg.train.mse_k_steps

    @jax.jit
    def eval_step(params, key, ys, encoder_inputs=None, controls=None):
        out = objective(params, key, ys, encoder_inputs, controls)
        fwd = out.filter_result
        fm = filtered_means(fwd)  # [B, T, Dx]
        # horizons beyond the trajectory have no targets: k > T-1 would turn
        # the `:T-k` slice negative and silently wrap (shape error / wrong R²)
        k_max_eff = min(k_max, ys.shape[1] - 1)
        preds = k_step_predictions(ssm, params, fm, k_max_eff, controls)

        t_steps = ys.shape[1]
        var_y = jnp.var(ys, axis=(0, 1)).mean()
        r2 = []
        mse = []
        for k in range(1, k_max_eff + 1):
            err = preds[k - 1, :, : t_steps - k] - ys[:, k:]
            mse_k = jnp.mean(err**2)
            mse.append(mse_k)
            r2.append(1.0 - mse_k / var_y)
        metrics = dict(out.metrics)
        metrics["elbo"] = jnp.mean(out.elbo)
        metrics["mse_k"] = jnp.stack(mse)
        metrics["r2_k"] = jnp.stack(r2)
        return metrics

    return eval_step


# ---------------------------------------------------------------------------
# Trainer driver
# ---------------------------------------------------------------------------


@dataclass
class TrainState:
    params: Any
    opt_state: Any
    key: jax.Array
    step: int = 0
    best_elbo: float = -np.inf
    evals_since_best: int = 0
    best_params: Any = None  # snapshot at the best test ELBO (keep_best)


class Trainer:
    """Cold-path orchestration around the two jitted functions.

    Handles minibatching, early stopping, metric logging, checkpoints —
    the reference's trainer.py responsibilities (SURVEY.md §2-A).
    """

    def __init__(
        self,
        cfg: Config,
        ssm: SSM,
        params,
        *,
        mesh=None,
        metrics_writer=None,
        checkpointer=None,
        profile_dir=None,
    ):
        self.mesh = mesh
        self.cfg = cfg
        self.ssm = ssm
        self.profile_dir = profile_dir  # jax.profiler trace target (SURVEY.md §5)
        self.optimizer = make_optimizer(cfg)
        if mesh is not None:
            # multi-device run: the train AND eval steps jit over the mesh —
            # batch shards over "data", particles over "particle"
            # (SURVEY.md §2-B / §7 M5).
            from psvo_tpu.parallel import sharding

            self.train_step = sharding.make_sharded_train_step(
                ssm, cfg, self.optimizer, mesh
            )
            self.eval_step = sharding.make_sharded_eval_step(ssm, cfg, mesh)
        else:
            self.train_step = make_train_step(ssm, cfg, self.optimizer)
            self.eval_step = make_eval_step(ssm, cfg)
        self.state = TrainState(
            params=params,
            opt_state=self.optimizer.init(params),
            key=run_key(cfg, 1),
        )
        self.metrics_writer = metrics_writer
        self.checkpointer = checkpointer
        self.history: list[dict] = []

    def restore(self):
        if self.checkpointer is not None:
            restored = self.checkpointer.restore(self.state)
            if restored is not None:
                self.state = restored
                if self.mesh is not None:
                    # the checkpoint restores onto one device; the mesh step
                    # needs replicated placement (see sharding.place_replicated).
                    from psvo_tpu.parallel import sharding

                    self.state.params = sharding.place_replicated(
                        self.mesh, self.state.params
                    )
                    self.state.opt_state = sharding.place_replicated(
                        self.mesh, self.state.opt_state
                    )
                    if self.state.best_params is not None:
                        self.state.best_params = sharding.place_replicated(
                            self.mesh, self.state.best_params
                        )
        return self.state.step

    def run(
        self,
        obs_train,
        obs_test,
        n_steps: Optional[int] = None,
        hidden_train=None,
        hidden_test=None,
        controls_train=None,
        controls_test=None,
    ) -> list[dict]:
        cfg = self.cfg
        n_train = obs_train.shape[0]
        bsz = min(cfg.train.batch_size, n_train)
        steps_per_epoch = max(n_train // bsz, 1)
        if n_steps is None:
            # reference-style epoch accounting: each epoch is one pass over
            # shuffled without-replacement minibatches (SURVEY.md §2-A trainer)
            if cfg.train.epochs > 0:
                n_steps = cfg.train.epochs * steps_per_epoch
            else:
                n_steps = cfg.train.n_steps
        obs_train = jnp.asarray(obs_train)
        obs_test = jnp.asarray(obs_test)
        # q_uses_true_X debug mode: condition the encoder proposal on the true
        # latents instead of observations (reference flag, SURVEY.md §5).
        use_true_x = cfg.smc.q_uses_true_x
        if use_true_x and (hidden_train is None or hidden_test is None):
            raise ValueError("q_uses_true_x=True requires hidden_train/test latents")
        hidden_train = jnp.asarray(hidden_train) if use_true_x else None
        hidden_test = jnp.asarray(hidden_test) if use_true_x else None
        use_controls = self.ssm.di > 0
        if use_controls and (controls_train is None or controls_test is None):
            raise ValueError("data.di > 0 requires controls_train/test")
        controls_train = jnp.asarray(controls_train) if use_controls else None
        controls_test = jnp.asarray(controls_test) if use_controls else None

        st = self.state
        t_start = time.perf_counter()
        steps_done_at = st.step
        stop = False
        spc = max(int(cfg.train.steps_per_call), 1)
        if spc > 1:
            # chunked stepping must land exactly on the eval/save boundaries
            # (st.step advances by whole chunks)
            for fname, cad in (("eval_every", cfg.train.eval_every),
                               ("save_every", cfg.train.save_every)):
                if cad % spc != 0:
                    raise ValueError(
                        f"train.{fname}={cad} must be a multiple of "
                        f"train.steps_per_call={spc}"
                    )
        profile_window = None
        if self.profile_dir:
            # trace a steady-state window: skip the compile-heavy first
            # steps; with chunked stepping the window aligns to chunks
            w0 = cfg.train.eval_every + spc if spc > 1 else cfg.train.eval_every + 1
            profile_window = (w0, w0 + max(10 // spc, 1) * spc)

        def _next_batch(step):
            # minibatch indices are a pure function of (seed, step) — of the
            # epoch, in epoch mode — so a resumed run draws exactly the
            # batches the uninterrupted run would have drawn
            if cfg.train.epochs > 0:
                epoch, pos = divmod(step, steps_per_epoch)
                perm = np.random.default_rng((cfg.seed + 2, epoch)).permutation(
                    n_train
                )
                idx = jnp.asarray(perm[pos * bsz : (pos + 1) * bsz])
            else:
                rng = np.random.default_rng((cfg.seed + 2, step))
                idx = jnp.asarray(rng.choice(n_train, size=bsz, replace=False))
            batch = jnp.take(obs_train, idx, axis=0)
            enc = jnp.take(hidden_train, idx, axis=0) if use_true_x else None
            ctrl = jnp.take(controls_train, idx, axis=0) if use_controls else None
            return batch, enc, ctrl

        while st.step < n_steps and not stop:
            chunk = min(spc, n_steps - st.step)  # tail chunk recompiles once
            if profile_window and st.step + chunk == profile_window[0]:
                jax.profiler.start_trace(self.profile_dir)
            if chunk == 1 and spc == 1:
                batch, enc, ctrl = _next_batch(st.step)
                st.key, k_step = jax.random.split(st.key)
            else:
                parts = [_next_batch(st.step + j) for j in range(chunk)]
                batch = jnp.stack([p[0] for p in parts])
                enc = jnp.stack([p[1] for p in parts]) if use_true_x else None
                ctrl = jnp.stack([p[2] for p in parts]) if use_controls else None
                ks = []
                for _ in range(chunk):  # the SAME split chain as spc=1
                    st.key, k_j = jax.random.split(st.key)
                    ks.append(k_j)
                k_step = jnp.stack(ks)
                # a tail chunk (chunk < spc) just scans fewer stacked steps;
                # it re-specializes the jitted program once at the very end
            st.params, st.opt_state, metrics = self.train_step(
                st.params, st.opt_state, k_step, batch, enc, ctrl
            )
            if "checkify_err" in metrics:  # cfg.train.debug_checks
                from jax.experimental import checkify

                checkify.check_error(metrics.pop("checkify_err"))
            st.step += chunk
            if profile_window and st.step == profile_window[1]:
                jax.block_until_ready(metrics["loss"])
                jax.profiler.stop_trace()
                print(f"profiler trace written to {self.profile_dir}", flush=True)
                profile_window = None

            if st.step % cfg.train.eval_every == 0 or st.step == n_steps:
                st.key, k_eval = jax.random.split(st.key)
                ev = self.eval_step(
                    st.params, k_eval, obs_test, hidden_test, controls_test
                )
                jax.block_until_ready(ev["elbo"])
                dt = time.perf_counter() - t_start
                steps_s = (st.step - steps_done_at) / max(dt, 1e-9)
                t_start, steps_done_at = time.perf_counter(), st.step
                rec = {
                    "step": st.step,
                    "train_loss": float(metrics["loss"]),
                    "train_elbo": float(metrics.get("log_z_fwd", -metrics["loss"])),
                    "test_elbo": float(ev["elbo"]),
                    "r2_1": float(ev["r2_k"][0]),
                    "r2_k": [float(v) for v in np.asarray(ev["r2_k"])],
                    "ess_mean": float(ev["ess_mean"]),
                    "grad_norm": float(metrics["grad_norm"]),
                    "steps_per_sec": steps_s,
                }
                # objective-specific extras (PSVO's direct smoothing bound +
                # EM log-joint, SVO's backward bound) persist to the record,
                # not just the in-memory eval dict — a user comparing bound
                # forms reads them from metrics.jsonl/history.json
                for extra in ("elbo_psvo_direct", "log_joint_smoothed", "elbo_svo"):
                    if extra in ev:
                        rec[extra] = float(ev[extra])
                self.history.append(rec)
                if self.metrics_writer is not None:
                    self.metrics_writer.write(rec)
                print(
                    f"step {rec['step']:6d}  train_elbo {rec['train_elbo']:10.2f}  "
                    f"test_elbo {rec['test_elbo']:10.2f}  R²(1) {rec['r2_1']:6.3f}  "
                    f"{steps_s:6.1f} steps/s",
                    flush=True,
                )

                if rec["test_elbo"] > st.best_elbo + 1e-6:
                    st.best_elbo = rec["test_elbo"]
                    st.evals_since_best = 0
                    if cfg.train.keep_best:
                        st.best_params = st.params
                else:
                    st.evals_since_best += 1
                    if st.evals_since_best >= cfg.train.patience:
                        print("early stopping: patience exhausted", flush=True)
                        stop = True

            if self.checkpointer is not None and st.step % cfg.train.save_every == 0:
                self.checkpointer.save(st)

        if cfg.train.keep_best and st.best_params is not None:
            # model selection: end the run on the best-test-ELBO params (long
            # runs can diverge late — observed on Lorenz-63 at lr 3e-3)
            st.params = st.best_params
        if self.checkpointer is not None:
            self.checkpointer.save(st, force=True)
        return self.history
