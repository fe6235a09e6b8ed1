"""Synthetic dataset simulation from ground-truth state-space models.

Covers the reference's data generation inside `runner.py`/`utils.py`
(SURVEY.md §2-A/§3.5, unverified paths): simulate `n_train + n_test`
trajectories of length T from a true SSM — FHN / Lorenz-63 / Lorenz-96
dynamics plus process noise, observed through a linear(-or-identity) Gaussian
or Poisson emission — returning (hidden, obs) splits with the true latents
kept for evaluation plots and R².

Shape: the whole simulator is one `lax.scan` over T vmapped over
trajectories, jitted once; datasets at reference scales (hundreds of
trajectories, T≈100–200) generate in milliseconds on-device, so there is no
separate host data-loading subsystem to port.
"""

from __future__ import annotations

from dataclasses import dataclass
from functools import partial

import jax
import jax.numpy as jnp

from psvo_tpu.config import DataConfig
from psvo_tpu.models import dynamics as dyn


@dataclass
class Dataset:
    obs_train: jax.Array  # [n_train, T, Dy]
    obs_test: jax.Array  # [n_test, T, Dy]
    hidden_train: jax.Array  # [n_train, T, Dx]
    hidden_test: jax.Array  # [n_test, T, Dx]
    emission_matrix: jax.Array  # [Dx, Dy] true emission map (for diagnostics)
    # exogenous control inputs (reference `Di`); None when DataConfig.di == 0
    controls_train: jax.Array | None = None  # [n_train, T, Di]
    controls_test: jax.Array | None = None  # [n_test, T, Di]
    control_matrix: jax.Array | None = None  # [Di, Dx] true control->drift map


# Burn-in pushes chaotic initial states onto the attractor before recording.
_BURN_IN = {"lorenz63": 500, "lorenz96": 500}
_X0_OFFSET = {"lorenz63": (0.0, 0.0, 25.0)}  # start near the attractor center


def _make_stepper(cfg: DataConfig):
    return dyn.make_stepper(cfg)


def emission_map(cfg: DataConfig, key: jax.Array) -> jax.Array:
    """Fixed [Dx, Dy] observation matrix: identity when square, else a random
    projection drawn once from the dataset seed (matches the reference's
    linear/identity emission options)."""
    if cfg.emission == "identity_gaussian" or cfg.dx == cfg.dy:
        eye = jnp.eye(cfg.dx, cfg.dy, dtype=jnp.float32)
        return eye
    return jax.random.normal(key, (cfg.dx, cfg.dy), jnp.float32) / jnp.sqrt(cfg.dx)


@partial(jax.jit, static_argnames=("cfg", "n_traj"))
def _simulate(cfg: DataConfig, key: jax.Array, n_traj: int):
    stepper = _make_stepper(cfg)
    k_x0, k_proc, k_obs, k_emit, k_ctrl, k_cmat = jax.random.split(key, 6)
    c_emit = emission_map(cfg, k_emit)

    # exogenous controls: iid N(0,1) inputs entering the drift through a
    # fixed random [Di, Dx] map (reference `Di` capability)
    if cfg.di:
        u_all = jax.random.normal(k_ctrl, (cfg.t_steps, n_traj, cfg.di))
        b_ctrl = (
            cfg.control_scale
            * jax.random.normal(k_cmat, (cfg.di, cfg.dx))
            / jnp.sqrt(float(cfg.di))
        )
    else:
        u_all = jnp.zeros((cfg.t_steps, n_traj, 0), jnp.float32)
        b_ctrl = jnp.zeros((0, cfg.dx), jnp.float32)

    offset = jnp.asarray(_X0_OFFSET.get(cfg.datatype, (0.0,) * cfg.dx), jnp.float32)
    x0 = offset + cfg.x0_scale * jax.random.normal(k_x0, (n_traj, cfg.dx))

    burn = _BURN_IN.get(cfg.datatype, 0)
    if burn:
        x0 = jax.lax.fori_loop(0, burn, lambda _, x: stepper.step(x), x0)

    def step(x, inputs):
        k_p, k_o, u_t = inputs
        x_next = (
            stepper.step(x)
            + u_t @ b_ctrl
            + cfg.proc_scale * jax.random.normal(k_p, x.shape)
        )
        proj = x_next @ c_emit
        if cfg.emission == "poisson":
            y = jax.random.poisson(k_o, jnp.exp(jnp.tanh(proj))).astype(jnp.float32)
        elif cfg.emission == "dirac":
            y = proj  # deterministic observation map (dirac_delta parity)
        else:
            y = proj + cfg.obs_scale * jax.random.normal(k_o, proj.shape)
        return x_next, (x_next, y)

    inputs = (
        jax.random.split(k_proc, cfg.t_steps),
        jax.random.split(k_obs, cfg.t_steps),
        u_all,
    )
    _, (xs, ys) = jax.lax.scan(step, x0, inputs)
    # scan stacks time first: [T, n, D] -> [n, T, D]
    return (
        jnp.swapaxes(xs, 0, 1),
        jnp.swapaxes(ys, 0, 1),
        c_emit,
        jnp.swapaxes(u_all, 0, 1),
        b_ctrl,
    )


def generate_dataset(cfg: DataConfig, seed: int) -> Dataset:
    key = jax.random.key(seed)
    hidden, obs, c_emit, ctrl, b_ctrl = _simulate(cfg, key, cfg.n_train + cfg.n_test)
    if not bool(jnp.isfinite(hidden).all()):
        # e.g. FHN's cubic term diverges under strong control pushes or a
        # too-large dt — fail loudly instead of training on NaN data
        raise ValueError(
            f"simulated {cfg.datatype} trajectories diverged (non-finite states); "
            "reduce control_scale/proc_scale or the integrator dt"
        )
    return Dataset(
        obs_train=obs[: cfg.n_train],
        obs_test=obs[cfg.n_train :],
        hidden_train=hidden[: cfg.n_train],
        hidden_test=hidden[cfg.n_train :],
        emission_matrix=c_emit,
        controls_train=ctrl[: cfg.n_train] if cfg.di else None,
        controls_test=ctrl[cfg.n_train :] if cfg.di else None,
        control_matrix=b_ctrl if cfg.di else None,
    )


# --- dataset persistence (reference parity: loading pre-generated datasets
# from data/, SURVEY.md §2-A L6c) -------------------------------------------

_FIELDS = (
    "obs_train",
    "obs_test",
    "hidden_train",
    "hidden_test",
    "emission_matrix",
    "controls_train",
    "controls_test",
    "control_matrix",
)


def save_dataset(ds: Dataset, path) -> None:
    import numpy as np

    arrays = {
        f: np.asarray(getattr(ds, f))
        for f in _FIELDS
        if getattr(ds, f) is not None
    }
    np.savez_compressed(path, **arrays)


def load_dataset(path) -> Dataset:
    import numpy as np

    with np.load(path) as z:
        return Dataset(
            **{f: jnp.asarray(z[f]) for f in _FIELDS if f in z.files}
        )
