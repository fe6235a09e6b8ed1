"""Device-mesh scaling: Mesh("data","particle"), sharded train step, dry run.

The reference has no distributed backend (SURVEY.md §2-B); the rebuild's
"backend" is exactly this module — PartitionSpecs over a
`jax.sharding.Mesh(("data", "particle"))` plus GSPMD-inserted XLA collectives
(NCCL between the cards of one host). No hand-written transport:

- batch-of-trajectories shards over "data" (pure data parallelism);
- the K-particle axis shards over "particle" (BASELINE.json config #5,
  K=8192, on the four cards of one host): per-step weight normalization
  becomes a psum and resampling a ppermute ring inside a shard_map island
  (`psvo_tpu.ops.sharded_resampling`); the layout constraints come from
  `psvo_tpu.parallel.context`;
- params/optimizer state replicate (networks are tiny MLPs — TP/PP are
  inapplicable by design, SURVEY.md §2-B).

Tested on 8 virtual CPU devices (tests/test_sharding.py,
`__graft_entry__.dryrun_multichip`) and run on four cards by
`chip_smoke.py --multi`.
"""

from __future__ import annotations

import dataclasses
from typing import Optional

import jax
import jax.numpy as jnp
import numpy as np
from jax.sharding import Mesh, NamedSharding, PartitionSpec as P

from psvo_tpu.config import Config
from psvo_tpu.parallel import context


def make_mesh(cfg: Config, devices=None) -> Mesh:
    devices = devices if devices is not None else jax.devices()
    n = cfg.mesh.data * cfg.mesh.particle
    if len(devices) < n:
        raise ValueError(
            f"config mesh {cfg.mesh} needs {n} devices, have {len(devices)}"
        )
    if cfg.smc.n_particles % cfg.mesh.particle:
        raise ValueError(
            f"K={cfg.smc.n_particles} not divisible by mesh.particle={cfg.mesh.particle}"
        )
    if cfg.train.batch_size % cfg.mesh.data:
        raise ValueError(
            f"batch_size={cfg.train.batch_size} not divisible by mesh.data={cfg.mesh.data}"
        )
    grid = np.asarray(list(devices[:n])).reshape(cfg.mesh.data, cfg.mesh.particle)
    return Mesh(grid, (context.DATA_AXIS, context.PARTICLE_AXIS))


def maybe_mesh(cfg: Config) -> Optional[Mesh]:
    """The CLI/Trainer entry: the configured mesh, or None for a 1×1 mesh.

    Raises (via make_mesh) when the mesh needs more devices than exist: a
    sharded preset runs sharded or not at all. Set mesh.data=1 and
    mesh.particle=1 to run it on one device."""
    if cfg.mesh.data * cfg.mesh.particle <= 1:
        return None
    return make_mesh(cfg)


def batch_sharding(mesh: Mesh) -> NamedSharding:
    return NamedSharding(mesh, P(context.DATA_AXIS, None, None))


def replicated(mesh: Mesh) -> NamedSharding:
    return NamedSharding(mesh, P())


def place_replicated(mesh: Mesh, tree):
    """Re-place a pytree (params / optimizer state) replicated over the mesh.

    A checkpoint restores arrays onto a single device; feeding those into a
    jitted mesh step raises "incompatible devices". Checkpoint restore under
    a mesh must therefore re-place explicitly (tests/test_sharding.py
    sharded checkpoint roundtrip)."""
    sh = replicated(mesh)
    return jax.tree_util.tree_map(lambda x: jax.device_put(x, sh), tree)


def make_sharded_train_step(ssm, cfg: Config, optimizer, mesh: Mesh):
    """The full training step jitted over the mesh.

    Activates the particle-sharding context so the SMC scan's [B, K, ...]
    tensors carry layout constraints; GSPMD then partitions the whole
    forward+backward program. Params/opt-state replicate; the gradient
    all-reduce over "data"×"particle" is emitted by XLA.
    """
    from psvo_tpu.train import make_train_step

    context.set_mesh(mesh)
    step = make_train_step(ssm, cfg, optimizer)  # jitted inside

    def wrapped(params, opt_state, key, batch, encoder_inputs=None, controls=None):
        batch = jax.device_put(batch, batch_sharding(mesh))
        if encoder_inputs is not None:
            encoder_inputs = jax.device_put(encoder_inputs, batch_sharding(mesh))
        if controls is not None:
            controls = jax.device_put(controls, batch_sharding(mesh))
        return step(params, opt_state, key, batch, encoder_inputs, controls)

    return wrapped


def make_sharded_eval_step(ssm, cfg: Config, mesh: Mesh):
    """Evaluation (test ELBO + k-step R²) over the mesh: the test batch
    shards over "data", particles over "particle" — same layout constraints
    as training, so eval never silently falls back to a replicated run."""
    from psvo_tpu.train import make_eval_step

    context.set_mesh(mesh)
    step = make_eval_step(ssm, cfg)

    def wrapped(params, key, ys, encoder_inputs=None, controls=None):
        ys = jax.device_put(ys, batch_sharding(mesh))
        if encoder_inputs is not None:
            encoder_inputs = jax.device_put(encoder_inputs, batch_sharding(mesh))
        if controls is not None:
            controls = jax.device_put(controls, batch_sharding(mesh))
        return step(params, key, ys, encoder_inputs, controls)

    return wrapped


def _dryrun_one(cfg, devices, label: str) -> str:
    """Jit + execute ONE sharded train step of `cfg` on `devices`; returns a
    printable summary. Raises on non-finite loss."""
    from psvo_tpu.models.ssm import init_ssm
    from psvo_tpu.train import make_optimizer

    mesh = make_mesh(cfg, devices)
    try:
        ssm, params = init_ssm(cfg, jax.random.key(0))
        optimizer = make_optimizer(cfg)
        opt_state = optimizer.init(params)
        step = make_sharded_train_step(ssm, cfg, optimizer, mesh)

        batch = jnp.zeros((cfg.train.batch_size, cfg.data.t_steps, cfg.data.dy))
        params, opt_state, metrics = step(params, opt_state, jax.random.key(1), batch)
        loss = float(jax.block_until_ready(metrics["loss"]))
        if not np.isfinite(loss):
            raise RuntimeError(
                f"sharded {label} train step produced non-finite loss {loss}"
            )
        return f"{label} K={cfg.smc.n_particles} loss={loss:.3f}"
    finally:
        context.set_mesh(None)


def dryrun(n_devices: int, verbose: bool = True) -> None:
    """Compile + execute sharded training steps on tiny shapes.

    Mesh shape: 2×(n/2) when n_devices ≥ 4 (exercising both axes), else 1×n.
    Two steps run: the FIVO filtering step (GSPMD
    constraints + psum normalizer + resampling island) AND a PSVO smoothing
    step — the sharded FFBSi backward island (ops/sharded_ffbsi.py) is the
    most intricate multi-device code in the framework and deserves
    driver-visible proof, not just CPU-suite coverage.
    """
    from psvo_tpu.config import preset

    devices = jax.devices()[:n_devices]
    if len(devices) < n_devices:
        raise RuntimeError(f"need {n_devices} devices, found {len(devices)}")
    d_data = 2 if n_devices >= 4 and n_devices % 2 == 0 else 1
    d_part = n_devices // d_data

    cfg = preset("lorenz96_fivo_k8192_sharded")
    cfg = dataclasses.replace(
        cfg,
        data=dataclasses.replace(cfg.data, t_steps=8, n_train=8, n_test=4),
        smc=dataclasses.replace(cfg.smc, n_particles=16 * d_part),
        train=dataclasses.replace(cfg.train, batch_size=2 * d_data),
        mesh=dataclasses.replace(cfg.mesh, data=d_data, particle=d_part),
    )
    fivo_summary = _dryrun_one(cfg, devices, "fivo")

    psvo = preset("lorenz63_psvo_k1024")
    psvo = dataclasses.replace(
        psvo,
        data=dataclasses.replace(psvo.data, t_steps=8, n_train=8, n_test=4),
        smc=dataclasses.replace(
            psvo.smc, n_particles=16 * d_part, n_smoothing_particles=4
        ),
        train=dataclasses.replace(psvo.train, batch_size=2 * d_data, steps_per_call=1),
        mesh=dataclasses.replace(psvo.mesh, data=d_data, particle=d_part),
    )
    psvo_summary = _dryrun_one(psvo, devices, "psvo")

    # segmented PSVO × mesh: the long-T FFBSi segment
    # recompute running INSIDE the per-segment shard_map islands is the
    # last intricate multi-device combination — prove it executes, not
    # just that the CPU suite covers it
    seg = dataclasses.replace(
        psvo,
        # T−1 must divide into segments: 9 steps → two 4-step segments
        data=dataclasses.replace(psvo.data, t_steps=9),
        smc=dataclasses.replace(psvo.smc, ffbsi_segments=2),
    )
    seg_summary = _dryrun_one(seg, devices, "psvo-seg2")

    if verbose:
        print(
            f"dryrun_multichip ok: mesh data={d_data} particle={d_part} "
            f"{fivo_summary}; {psvo_summary}; {seg_summary}"
        )
