"""Typed configuration tree + experiment presets.

Covers the reference's `runner_flag.py` (SURVEY.md §2-A/§5): every
reconstructed `tf.app.flags` flag has a named field here. Parity table
(reference flag -> field):

  Dx, Dy, Di                  -> DataConfig.dx, .dy, .di
  n_particles (K)             -> SMCConfig.n_particles
  batch_size / lr / epoch     -> TrainConfig.batch_size / .lr / .epochs (or .n_steps)
  seed                        -> Config.seed
  datatype {fhn,lorenz,...}   -> DataConfig.datatype
  time (T) / n_train / n_test -> DataConfig.t_steps / .n_train / .n_test
  q0/q1/q2/f/g layer sizes    -> Config.nets["q0"|"q1"|"q2"|"f"|"g"].hidden
  sigma_init / sigma_min      -> NetConfig.sigma_init / .sigma_min (per net)
  IWAE/AESMC/SVO/PSVO flags   -> SMCConfig.objective (single enum-like string)
  use_bootstrap               -> SMCConfig.use_bootstrap
  use_2_q                     -> SMCConfig.use_2q
  q_uses_true_X (debug)       -> SMCConfig.q_uses_true_x
  use_stop_gradient           -> SMCConfig.use_stop_gradient
  n_bw_particles (M)          -> SMCConfig.n_smoothing_particles
  backward-proposal net sizes -> Config.nets["qb"].hidden
  MSE_steps (k-step R^2)      -> TrainConfig.mse_k_steps
  print/save frequencies      -> TrainConfig.eval_every / .save_every

Configs are frozen dataclasses: hashable (usable as jit static args), JSON
round-trippable (`to_dict`/`from_dict`), and content-hashed into checkpoints
and metric logs (`config_hash`).
"""

from __future__ import annotations

import dataclasses
import hashlib
import json
import typing
from dataclasses import dataclass, field
from typing import Any

OBJECTIVES = ("iwae", "fivo", "svo", "psvo")
RESAMPLERS = ("systematic", "multinomial", "none")


@dataclass(frozen=True)
class NetConfig:
    """One conditional head (proposal / transition / emission / backward proposal)."""

    hidden: tuple[int, ...] = (64, 64)
    activation: str = "relu"
    # "const": trainable state-independent diagonal scale (reference default)
    # "head":  diagonal scale from a second linear head on the trunk
    # "tril":  trainable state-independent FULL covariance (Cholesky factor,
    #          softplus-floored diagonal) — the reference mvn's "full" option;
    #          supported for the transition f and emission g (proposals stay
    #          diagonal: the use_2q precision fusion is diagonal math)
    # "tril_head": STATE-DEPENDENT full covariance — packed Cholesky factor
    #          from two linear heads on the trunk (floored-softplus diagonal,
    #          free strict-lower); supported on f and g for every objective
    # "none":  mean-only network (Dirac / Poisson log-rate heads)
    cov_type: str = "const"
    sigma_init: float = 1.0
    # scale floor: 1e-3 lets a single degenerate particle contribute
    # |log-density| ~ 1e6 with gradient ~ 1e6/σ — measured gradient-norm
    # spikes to 1e14 at K=1024. 1e-2 is far below any benchmark's true noise
    # scale while bounding the spikes two orders lower.
    sigma_min: float = 1e-2


@dataclass(frozen=True)
class DataConfig:
    """Synthetic dataset generation (reference data-gen inside runner.py)."""

    datatype: str = "fhn"  # "fhn" | "lorenz63" | "lorenz96" | "lgssm"
    dx: int = 2
    dy: int = 2
    di: int = 0  # exogenous control input dim (reference `Di`); 0 = none.
    # When di > 0 the simulator draws iid N(0,1) controls and adds
    # B_u @ u_t (a fixed random [Di, Dx] map) to the drift; the learned
    # transition/dynamics-proposal heads condition on [x_prev, u_t].
    control_scale: float = 1.0  # magnitude of the true control effect
    t_steps: int = 100
    n_train: int = 200
    n_test: int = 40
    emission: str = "linear_gaussian"  # | "poisson" | "identity_gaussian" | "dirac"
    obs_scale: float = 0.2  # emission noise std
    proc_scale: float = 0.1  # process noise std injected during simulation
    dyn_overrides: tuple[tuple[str, Any], ...] = ()  # e.g. (("dt", 0.25),)
    x0_scale: float = 1.0  # std of the initial-state draw


@dataclass(frozen=True)
class SMCConfig:
    """Objective family + particle-filter behavior (reference SMC/*.py)."""

    objective: str = "fivo"  # one of OBJECTIVES
    n_particles: int = 128  # K
    n_smoothing_particles: int = 16  # M backward draws (SVO/PSVO)
    ffbsi_segments: int = 1  # >1: segmented PSVO cache for long T (SURVEY.md §5):
    # store carries at T/(segments) boundaries, recompute segment interiors
    # during the backward sweep instead of caching all T steps in HBM.
    resampling: str = "systematic"  # "systematic" | "multinomial" | "none"
    # PSVO training bound: "forward" (Rao-Blackwellized — reported ELBO is
    # the forward logZ, smoothing enters via the EM surrogate) | "direct"
    # (the reference-form sampled-backward-trajectory bound
    # logsumexp_m(log p − log q̃) − log M with the discrete-support q̃;
    # see objectives.py for its support-size-offset caveat). Both always
    # report the `elbo_psvo_direct` metric.
    psvo_bound: str = "forward"
    # SVO backward proposal architecture (SURVEY.md §2-A tags the
    # reference's q_b as "MLP/RNN-parameterized" [M]): False = MLP on
    # [x_{t+1}, y_t]; True = additionally condition on h_t, a backward-GRU
    # summary of y_{t:T} (the RNN parameterization — the recurrence runs
    # per-trajectory [B, ·], outside the M-path bulk math). SVO only; PSVO's
    # FFBSi draws over the discrete forward support and has no q_b network.
    qb_rnn: bool = False
    transition: str = "mlp"  # "mlp" | "known": f's mean is the TRUE dynamics
    # stepper (FHN/Lorenz/LGSSM from data.datatype) with a learned noise
    # scale — the learn-proposals-only ablation the reference's bootstrap
    # mode gestures at (models/dynamics.py role 2).
    ess_threshold: float = 1.0  # resample when ESS/K < threshold; 1.0 = always
    use_2q: bool = True  # fuse q1(x|x_prev) with encoder q2(x|y)
    remat: bool = True  # rematerialize the scan body in backprop (SURVEY.md §5):
    # without it the T-step scan stores every MLP activation ([B*K, hidden] ×
    # nets × T ≈ GBs at K=1024), thrashing HBM; with it only the O(B*K*Dx)
    # carries persist and activations recompute during the backward sweep.
    use_bootstrap: bool = False  # proposal := transition f
    use_stop_gradient: bool = True  # stop-grad through resampling indices
    q_uses_true_x: bool = False  # debug: condition proposal on true latents


@dataclass(frozen=True)
class TrainConfig:
    lr: float = 3e-3
    lr_schedule: str = "const"  # "const" | "cosine" (decay to 10% over n_steps)
    keep_best: bool = True  # restore the best-test-ELBO params at end of run
    batch_size: int = 32
    n_steps: int = 2000
    epochs: int = 0  # >0: reference-style epoch accounting — each epoch is one
    # pass over shuffled without-replacement minibatches (overrides n_steps
    # with epochs * floor(n_train / batch_size)).
    clip_norm: float = 10.0
    eval_every: int = 100
    save_every: int = 500
    patience: int = 20  # early stopping, in eval periods
    mse_k_steps: int = 10  # k-step-ahead prediction R^2 horizon
    bf16_matmuls: bool = False  # run MLP trunk matmuls in bf16 (f32 accumulation)
    # PRNG implementation for every run key ("threefry2x32" | "rbg").
    # Streams differ between impls, and rbg's streams also differ across
    # backends, so threefry is the default: the same seed gives the same run
    # on the GPU and on the CPU.
    rng_impl: str = "threefry2x32"
    # checkify float checks on the train step (SURVEY.md §5 sanitizers row):
    # reports WHERE the first non-finite value was produced, compiled — no
    # op-by-op eager re-execution like --debug-nans. Debug builds only.
    debug_checks: bool = False
    # Train steps per jitted call (lax.scan over N steps inside one XLA
    # program), which amortizes the host's per-call dispatch over N steps.
    # Key derivation is the same split chain as N=1, so trajectories are
    # bit-identical across values. eval/save cadences must be multiples of N.
    steps_per_call: int = 1


@dataclass(frozen=True)
class MeshConfig:
    """Device mesh for jit/shard_map (rebuild-only; reference is single-device)."""

    data: int = 1  # shards of the trajectory batch axis
    particle: int = 1  # shards of the K-particle axis


def _default_nets() -> tuple[tuple[str, NetConfig], ...]:
    return (
        ("q0", NetConfig()),  # initial proposal q0(x_0 | y_0)
        ("q1", NetConfig()),  # dynamics proposal q1(x_t | x_{t-1})
        ("q2", NetConfig()),  # encoder proposal q2(x_t | y_t)
        ("f", NetConfig()),  # transition f(x_t | x_{t-1})
        ("g", NetConfig(sigma_init=0.5)),  # emission g(y_t | x_t)
        ("qb", NetConfig()),  # backward proposal q_b(x_t | x_{t+1}, y_t) [SVO]
    )


@dataclass(frozen=True)
class Config:
    name: str = "default"
    seed: int = 0
    data: DataConfig = field(default_factory=DataConfig)
    smc: SMCConfig = field(default_factory=SMCConfig)
    train: TrainConfig = field(default_factory=TrainConfig)
    mesh: MeshConfig = field(default_factory=MeshConfig)
    nets: tuple[tuple[str, NetConfig], ...] = field(default_factory=_default_nets)

    def net(self, name: str) -> NetConfig:
        for k, v in self.nets:
            if k == name:
                return v
        raise KeyError(name)

    def with_nets(self, **updates: NetConfig) -> "Config":
        nets = tuple((k, updates.get(k, v)) for k, v in self.nets)
        return dataclasses.replace(self, nets=nets)

    def to_dict(self) -> dict:
        return dataclasses.asdict(self)

    def config_hash(self) -> str:
        blob = json.dumps(self.to_dict(), sort_keys=True, default=str)
        return hashlib.sha256(blob.encode()).hexdigest()[:12]

    def resume_hash(self) -> str:
        """Hash of everything that must match for a checkpoint to be loadable.

        Run-control knobs (total steps, eval/save cadence, patience, batch
        size, learning rate) may legitimately change across resumes — e.g.
        `--steps 250` continuing a 200-step run, or an lr drop — so they are
        excluded; anything shaping params/optimizer-state structure is not.
        """
        d = self.to_dict()
        for k in ("n_steps", "epochs", "eval_every", "save_every", "patience", "batch_size", "lr", "debug_checks", "steps_per_call"):
            d["train"].pop(k, None)
        blob = json.dumps(d, sort_keys=True, default=str)
        return hashlib.sha256(blob.encode()).hexdigest()[:12]


def _deep_tuple(v):
    """Recursively convert lists to tuples (JSON round-trips turn tuples into
    lists; nested ones like data.dyn_overrides must come back hashable or the
    frozen config can't be a jit static arg)."""
    if isinstance(v, (list, tuple)):
        return tuple(_deep_tuple(x) for x in v)
    return v


def _tupled(d: dict, cls):
    """Rebuild a (possibly nested) frozen dataclass from a dict, tupling lists."""
    # `from __future__ import annotations` makes f.type a *string*; resolve
    # real types via get_type_hints so nested-dataclass fields reconstruct.
    hints = typing.get_type_hints(cls)
    kwargs = {}
    for f in dataclasses.fields(cls):
        if f.name not in d:
            continue
        v = d[f.name]
        t = hints.get(f.name, f.type)
        if isinstance(t, type) and dataclasses.is_dataclass(t) and isinstance(v, dict):
            v = _tupled(v, t)
        kwargs[f.name] = _deep_tuple(v) if isinstance(v, (list, tuple)) else v
    return cls(**kwargs)


def from_dict(d: dict) -> Config:
    nets = tuple(
        (k, _tupled(dict(v), NetConfig)) for k, v in (d.get("nets") or _default_nets())
    )
    return Config(
        name=d.get("name", "default"),
        seed=d.get("seed", 0),
        data=_tupled(d.get("data", {}), DataConfig),
        smc=_tupled(d.get("smc", {}), SMCConfig),
        train=_tupled(d.get("train", {}), TrainConfig),
        mesh=_tupled(d.get("mesh", {}), MeshConfig),
        nets=nets,
    )


# ---------------------------------------------------------------------------
# Presets: the five BASELINE.json benchmark configs, verbatim mapping.
# ---------------------------------------------------------------------------

PRESETS: dict[str, Config] = {
    # Presets up to K=1024 run several train steps per jitted call
    # (train.steps_per_call); the chunked path is bit-identical to single
    # stepping (tested).
    # 1. "IWAE (no resampling), FitzHugh–Nagumo 2D SSM, K=16 particles, T=100"
    "fhn_iwae_k16": Config(
        name="fhn_iwae_k16",
        data=DataConfig(datatype="fhn", dx=2, dy=2, t_steps=100),
        smc=SMCConfig(objective="iwae", n_particles=16, resampling="none"),
        train=TrainConfig(steps_per_call=50),
    ),
    # 2. "FIVO/AESMC filtering with systematic resampling, FHN, K=128, batched"
    "fhn_fivo_k128": Config(
        name="fhn_fivo_k128",
        data=DataConfig(datatype="fhn", dx=2, dy=2, t_steps=100),
        smc=SMCConfig(
            objective="fivo", n_particles=128, resampling="systematic",
        ),
        train=TrainConfig(steps_per_call=10),
    ),
    # 3. "SVO smoothing with learned backward proposal, Lorenz-63 3D latent, K=256"
    "lorenz63_svo_k256": Config(
        name="lorenz63_svo_k256",
        data=DataConfig(datatype="lorenz63", dx=3, dy=3, t_steps=100, obs_scale=0.5),
        smc=SMCConfig(
            objective="svo",
            n_particles=256,
            n_smoothing_particles=16,
            resampling="systematic",
        ),
        train=TrainConfig(steps_per_call=10),
    ),
    # 4. "PSVO full FFBSi backward-simulation smoother, Lorenz-63, K=1024"
    "lorenz63_psvo_k1024": Config(
        name="lorenz63_psvo_k1024",
        data=DataConfig(datatype="lorenz63", dx=3, dy=3, t_steps=100, obs_scale=0.5),
        smc=SMCConfig(
            objective="psvo",
            n_particles=1024,
            n_smoothing_particles=16,
            resampling="systematic",
        ),
        train=TrainConfig(steps_per_call=10),
    ),
    # 5. "Scaled Lorenz-96 D=40 latent, K=8192 particles", sharded over the
    # four cards of one host
    "lorenz96_fivo_k8192_sharded": Config(
        name="lorenz96_fivo_k8192_sharded",
        data=DataConfig(
            datatype="lorenz96", dx=40, dy=40, t_steps=100, obs_scale=0.5
        ),
        smc=SMCConfig(
            objective="fivo", n_particles=8192, resampling="systematic",
        ),
        mesh=MeshConfig(data=1, particle=4),
        train=TrainConfig(batch_size=8),
    ),
    # --- reference capability-parity modes (round 2) ---
    # exogenous control inputs (reference `Di`). control_scale 0.5: FHN's
    # cubic term diverges under stronger sustained pushes at T=100 (the
    # simulator checks and refuses non-finite trajectories).
    "fhn_fivo_controls": Config(
        name="fhn_fivo_controls",
        data=DataConfig(datatype="fhn", dx=2, dy=2, di=2, control_scale=0.5, t_steps=100),
        smc=SMCConfig(objective="fivo", n_particles=128),
    ),
    # learn-proposals-only ablation: frozen TRUE dynamics + learned noise
    "fhn_fivo_known_dynamics": Config(
        name="fhn_fivo_known_dynamics",
        data=DataConfig(datatype="fhn", dx=2, dy=2, t_steps=100),
        smc=SMCConfig(objective="fivo", n_particles=128, transition="known"),
    ),
    # trainable constant full-covariance transition + emission
    "fhn_fivo_tril": Config(
        name="fhn_fivo_tril",
        data=DataConfig(datatype="fhn", dx=2, dy=2, t_steps=100),
        smc=SMCConfig(objective="fivo", n_particles=128),
    ).with_nets(
        f=NetConfig(cov_type="tril"), g=NetConfig(cov_type="tril", sigma_init=0.5)
    ),
    # deterministic observation map (reference dirac_delta)
    "fhn_fivo_dirac": Config(
        name="fhn_fivo_dirac",
        data=DataConfig(datatype="fhn", dx=2, dy=2, t_steps=100, emission="dirac"),
        smc=SMCConfig(objective="fivo", n_particles=128),
    ),
    # Primary benchmark metric config: FHN, K=1024 (BASELINE.json "metric").
    "fhn_fivo_k1024_bench": Config(
        name="fhn_fivo_k1024_bench",
        data=DataConfig(datatype="fhn", dx=2, dy=2, t_steps=100),
        smc=SMCConfig(
            objective="fivo", n_particles=1024, resampling="systematic",
        ),
        train=TrainConfig(steps_per_call=10),
    ),
}


def preset(name: str) -> Config:
    try:
        return PRESETS[name]
    except KeyError:
        raise ValueError(f"unknown preset {name!r}; options: {sorted(PRESETS)}")
