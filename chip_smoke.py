"""Smoke test of psvo_tpu on NVIDIA GPUs: the quickest proof that the system
still starts, trains and computes the right numbers on the card.

    python chip_smoke.py            # one GPU: every phase below
    python chip_smoke.py --multi    # four GPUs: only the sharded paths

One card, at the presets' own widths:
  device       JAX's device kind beside `nvidia-smi`'s name and power limit;
  objectives   train steps of every BASELINE preset and of long-T segmented
               PSVO: step time and the device's running peak memory;
  train        `psvo_tpu.cli train` on the primary preset for 20 steps, then
               a resume from its checkpoint compared with a run that never
               stopped;
  gpu-vs-cpu   the primary preset and PSVO K=1024 on the GPU and on this
               process's CPU device, same key, same noise, `highest` matmul
               precision: log Ẑ, gradient norm and gradient direction;
  oracles      FIVO K=4096 log Ẑ against the Kalman log-likelihood and FFBSi
               smoothed means against RTS on a linear-Gaussian model;
  precision    the primary preset's ELBO at the default matmul precision
               against `highest` (reported, not judged);
  inference    filter_posterior / smooth_posterior on held-out streams with
               the trained params.
Four cards (--multi): L96 K=8192 on a 1×4 particle mesh, PSVO K=1024 on a
1×4 particle mesh and the primary preset at B=128 on a 4×1 data mesh, each
against the same step on one card.

Every phase raises on failure. The last stdout line is
{"ok": true, "device": {"platform", "kind", "count"}}, printed only when all
phases passed. With no GPU the script prints no result and exits 1.
"""

from __future__ import annotations

import argparse
import dataclasses
import json
import math
import sys
import tempfile
import time
from pathlib import Path

import numpy as np

PRIMARY = "fhn_fivo_k1024_bench"
LONG_T = "lorenz63_psvo_k1024_t1025_seg8"
# L96 K=8192 has the largest peak memory measured on the H100 and runs last:
# the device's peak is a running maximum, so a row's figure is its own peak
# only where it exceeds every row before it.
ONE_CARD_ROWS = (
    "fhn_iwae_k16",
    "fhn_fivo_k128",
    "lorenz63_svo_k256",
    PRIMARY,
    "lorenz63_psvo_k1024",
    LONG_T,
    "lorenz96_fivo_k8192_sharded",
)


def log(msg: str) -> None:
    print(msg, flush=True)


def card() -> str:
    from psvo_tpu.benchmark import nvidia_smi_name_power

    return nvidia_smi_name_power()


def _rel(a: float, b: float) -> float:
    return abs(a - b) / max(abs(b), 1e-30)


# ---------------------------------------------------------------------------
# objectives: one train-step window per preset
# ---------------------------------------------------------------------------


def one_card_configs(shrink=lambda c: c):
    """Every BASELINE preset on a 1×1 mesh, and the long-T row."""
    from psvo_tpu.benchmark import long_t_config, single_device
    from psvo_tpu.config import preset

    return [
        shrink(long_t_config() if n == LONG_T else single_device(preset(n)))
        for n in ONE_CARD_ROWS
    ]


def phase_objectives(cfgs, steps: int = 3) -> list[dict]:
    from psvo_tpu.benchmark import measure

    rows, peak = [], None
    for cfg in cfgs:
        row = measure(cfg, steps)
        if not math.isfinite(row["loss"]):
            raise AssertionError(f"{cfg.name}: non-finite loss {row['loss']}")
        own = peak is None or (row["peak_bytes_in_use"] or 0) > peak
        peak = row["peak_bytes_in_use"] or 0
        log(
            f"[objectives] {cfg.name} objective={cfg.smc.objective} "
            f"K={cfg.smc.n_particles} B={cfg.train.batch_size} T={cfg.data.t_steps} "
            f"step_time_ms={row['step_time_ms']} steps_per_s={row['value']} "
            f"warmup_s={row['warmup_s']} peak_bytes_in_use={row['peak_bytes_in_use']} "
            f"({'this row' if own else 'an earlier row'}) "
            f"loss={row['loss']} | {row['device']}"
        )
        rows.append(row)
    return rows


# ---------------------------------------------------------------------------
# train: the CLI, 20 steps, resume
# ---------------------------------------------------------------------------


def _cli_train(root: Path, n_steps: int, args: list[str], resume: str | None = None):
    from psvo_tpu import cli

    argv = ["train", *args, "--steps", str(n_steps), "--results-root", str(root)]
    if resume:
        argv += ["--resume", resume]
    rc = cli.main(argv)
    if rc != 0:
        raise AssertionError(f"cli train returned {rc}")
    (run_dir,) = [p for p in root.iterdir() if p.is_dir()]
    return run_dir, json.loads((run_dir / "history.json").read_text())


def phase_train(workdir: Path, preset: str = PRIMARY, steps: int = 20,
                more: int = 10, sets: tuple[str, ...] = ()) -> Path:
    """Train `steps` steps through the CLI (one eval, hence one recorded
    loss, per step), resume from the checkpoint to steps+more, and compare
    the resumed steps with a run of steps+more that never stopped. Returns
    the first run's directory."""
    args = ["--preset", preset]
    for kv in (
        "train.eval_every=1", "train.steps_per_call=1",
        f"train.save_every={steps}", "train.keep_best=false",
        "train.patience=1000000", *sets,
    ):
        args += ["--set", kv]
    first_dir, first = _cli_train(workdir / "first", steps, args)
    _, resumed = _cli_train(
        workdir / "resumed", steps + more, args, resume=str(first_dir / "checkpoints")
    )
    _, straight = _cli_train(workdir / "straight", steps + more, args)

    losses = [r["train_loss"] for r in first]
    if len(losses) != steps or not all(math.isfinite(v) for v in losses):
        raise AssertionError(f"expected {steps} finite losses, got {losses}")
    if [r["step"] for r in resumed] != list(range(steps + 1, steps + more + 1)):
        raise AssertionError(f"resume did not continue at step {steps + 1}")
    # the same run twice: the device's own run-to-run spread (0 when its
    # reductions are deterministic) bounds what the resume may differ by. The
    # two runs drift apart as they go, and the resumed steps come later than
    # the steps the spread is taken over (on the H100 the resume's difference
    # was 2.6 times the spread), hence the factor 10. A resume on the wrong
    # minibatches moves the loss by several percent.
    noise = max(_rel(a["train_loss"], b["train_loss"]) for a, b in zip(first, straight))
    diff = max(
        _rel(a["train_loss"], b["train_loss"])
        for a, b in zip(resumed, straight[steps:])
    )
    tol = max(1e-6, 10.0 * noise)
    sec = sorted(1.0 / r["steps_per_sec"] for r in first[1:])
    log(f"[train] {preset} losses={losses}")
    log(
        f"[train] steady seconds per step incl. its eval (median of steps 2..{steps}) "
        f"= {sec[len(sec) // 2]} | {card()}"
    )
    log(
        f"[train] resume: steps {steps + 1}..{steps + more} vs the straight run: "
        f"max rel loss diff {diff} (run-to-run spread {noise}, limit {tol})"
    )
    if diff > tol:
        raise AssertionError(f"resume is not step-exact: {diff} > {tol}")
    return first_dir


# ---------------------------------------------------------------------------
# gpu-vs-cpu and precision: same key, same noise
# ---------------------------------------------------------------------------


def _setup(cfg, with_noise: bool = True):
    import jax
    import jax.numpy as jnp

    from psvo_tpu.data import generate_dataset
    from psvo_tpu.models.ssm import init_ssm
    from psvo_tpu.objectives import make_objective
    from psvo_tpu.ops import resampling
    from psvo_tpu.utils.rng import run_key

    cpu = jax.devices("cpu")[0]
    ds = generate_dataset(cfg.data, cfg.seed)
    ssm, params = init_ssm(cfg, run_key(cfg))
    ys = jnp.asarray(ds.obs_train[: cfg.train.batch_size])
    b, t, _ = ys.shape
    k, dx = cfg.smc.n_particles, ssm.dx
    key = jax.random.key(1234)  # threefry: the same bits on every backend
    if not with_noise:
        return ssm, make_objective(ssm, cfg), params, key, ys, None
    with jax.default_device(cpu):
        k0, k1, k2 = jax.random.split(key, 3)
        noise = (
            jax.random.normal(k0, (b, dx, k)),
            jax.random.normal(k1, (t - 1, b, dx, k)),
            resampling.bulk_positions(k2, t - 1, b, k, cfg.smc.resampling)
            if cfg.smc.resampling != "none"
            else jnp.zeros((t - 1, b, 1)),
        )
    return ssm, make_objective(ssm, cfg), params, key, ys, noise


def phase_gpu_vs_cpu(cfg, devices) -> str:
    """value_and_grad of the objective on devices[0] and devices[1] (the GPU
    and the CPU) with identical inputs; see benchmark.grads_agree for why
    the comparison is log Ẑ, gradient norm and cosine."""
    import jax

    from psvo_tpu.benchmark import grads_agree

    _, obj, params, key, ys, noise = _setup(cfg)
    step = jax.jit(jax.value_and_grad(lambda p, k, y, n: obj(p, k, y, noise=n).loss))
    out = []
    with jax.default_matmul_precision("highest"):
        for dev in devices:
            args = jax.device_put((params, key, ys, noise), dev)
            t0 = time.perf_counter()
            v, g = jax.block_until_ready(step(*args))
            out.append((-float(v), g, time.perf_counter() - t0))
    (lz_a, g_a, s_a), (lz_b, g_b, s_b) = out
    ok, detail = grads_agree(lz_a, lz_b, g_a, g_b, f"gpu-vs-cpu {cfg.name}")
    log(
        f"[gpu-vs-cpu] {cfg.name} {devices[0].platform} vs {devices[1].platform}: "
        f"{detail} (first call incl. compile {s_a:.1f}s / {s_b:.1f}s)"
    )
    if not ok:
        raise AssertionError(f"{cfg.name}: GPU and CPU disagree: {detail}")
    return detail


def phase_precision(cfg, device) -> tuple[float, float]:
    """Mean log Ẑ of one batch at the default matmul precision and at
    `highest`, same noise (on a GPU the default may run f32 dots in TF32)."""
    import jax
    import jax.numpy as jnp

    _, obj, params, key, ys, noise = _setup(cfg)
    args = jax.device_put((params, key, ys, noise), device)
    vals = []
    for precision in ("default", "highest"):
        with jax.default_matmul_precision(precision):
            f = jax.jit(lambda p, k, y, n: jnp.mean(obj(p, k, y, noise=n).elbo))
            vals.append(float(f(*args)))
    lz_def, lz_hi = vals
    if not all(math.isfinite(v) for v in vals):
        raise AssertionError(f"non-finite ELBO: {vals}")
    log(
        f"[precision] {cfg.name} ELBO default={lz_def} highest={lz_hi} "
        f"drift abs={lz_def - lz_hi} rel={_rel(lz_def, lz_hi)} | {card()}"
    )
    return lz_def, lz_hi


# ---------------------------------------------------------------------------
# exact oracles on the linear-Gaussian model
# ---------------------------------------------------------------------------


def phase_oracles(k: int = 4096, seeds: int = 8, batch: int = 4, t_steps: int = 20,
                  m: int = 64, smooth_seeds: int = 3) -> None:
    import jax
    import jax.numpy as jnp

    from psvo_tpu.objectives import make_objective
    from tests import helpers
    from tests.reference_numpy import kalman_filter, rts_smoother

    p = helpers.default_lgssm()
    _, ys = helpers.simulate_lgssm(
        np.random.default_rng(42), t_steps=t_steps, batch=batch, **p
    )
    q, r, s0 = (s**2 * np.eye(2) for s in (p["q_scale"], p["r_scale"], p["s0_scale"]))
    kf = np.array([kalman_filter(y, p["a"], p["c"], q, r, p["mu0"], s0)[0] for y in ys])
    rts = np.stack([rts_smoother(y, p["a"], p["c"], q, r, p["mu0"], s0)[0] for y in ys])
    ys = jnp.asarray(ys)

    cfg, ssm, params = helpers.lgssm_setup(
        objective="fivo", n_particles=k, t_steps=t_steps, **p
    )
    fivo = jax.jit(make_objective(ssm, cfg))
    vals = np.stack([np.asarray(fivo(params, jax.random.key(s), ys).elbo) for s in range(seeds)])
    err = vals.mean(0) - kf
    se = vals.std(0, ddof=1) / np.sqrt(seeds)
    # E[log Ẑ] sits below log Z by about Var/2 (Jensen): allow 0.1 nat for it
    limit = 4.0 * se + 0.1
    log(
        f"[oracles] FIVO K={k}: log Ẑ − Kalman per trajectory {err.tolist()} "
        f"(limit 4·SE + 0.1 = {limit.tolist()})"
    )
    if np.any(np.abs(err) > limit):
        raise AssertionError(f"FIVO log Ẑ off the Kalman log-likelihood: {err}")

    cfg, ssm, params = helpers.lgssm_setup(
        objective="psvo", n_particles=k, n_smoothing=m, t_steps=t_steps, **p
    )
    psvo = jax.jit(make_objective(ssm, cfg))
    sm = np.mean(
        [np.asarray(psvo(params, jax.random.key(s), ys).smoothed) for s in range(smooth_seeds)],
        axis=(0, 3),
    )
    rmse = float(np.sqrt(np.mean((np.swapaxes(sm, 0, 1) - rts) ** 2)))
    log(f"[oracles] FFBSi K={k} M={m}: smoothed-mean RMSE vs RTS {rmse} (limit 0.12)")
    if rmse > 0.12:
        raise AssertionError(f"FFBSi smoothed means off RTS: rmse {rmse}")


# ---------------------------------------------------------------------------
# inference with the trained params
# ---------------------------------------------------------------------------


def phase_inference(run_dir: Path, n_streams: int = 8) -> None:
    import jax
    import jax.numpy as jnp

    from psvo_tpu import infer
    from psvo_tpu.config import from_dict
    from psvo_tpu.data import generate_dataset
    from psvo_tpu.models.ssm import init_ssm
    from psvo_tpu.utils.checkpoint import Checkpointer
    from psvo_tpu.utils.rng import run_key

    cfg = from_dict(json.loads((run_dir / "params.json").read_text()))
    ssm, template = init_ssm(cfg, run_key(cfg))
    params = Checkpointer(run_dir / "checkpoints", cfg.resume_hash()).restore_params(template)
    if params is None:
        raise AssertionError(f"no checkpoint in {run_dir}")
    ys = jnp.asarray(generate_dataset(cfg.data, cfg.seed).obs_test[:n_streams])
    for name, fn in (
        ("filter_posterior", lambda p, y: infer.filter_posterior(ssm, p, y, cfg)),
        ("smooth_posterior", lambda p, y: infer.smooth_posterior(ssm, p, y, cfg)),
    ):
        f = jax.jit(fn)
        out = jax.block_until_ready(f(params, ys))
        t0 = time.perf_counter()
        jax.block_until_ready(f(params, ys))
        dt = time.perf_counter() - t0
        if not np.all(np.isfinite(np.asarray(out))):
            raise AssertionError(f"{name}: non-finite output")
        log(
            f"[inference] {name} {n_streams} streams T={cfg.data.t_steps} "
            f"K={cfg.smc.n_particles}: shape {tuple(out.shape)} in {dt}s | {card()}"
        )


# ---------------------------------------------------------------------------
# four cards
# ---------------------------------------------------------------------------


def multi_configs(shrink=lambda c: c):
    """The three sharded paths: the particle ring (L96), the sharded FFBSi
    island (PSVO) and data parallelism (primary preset at B=128)."""
    from psvo_tpu.config import MeshConfig, preset

    l96 = dataclasses.replace(
        preset("lorenz96_fivo_k8192_sharded"), mesh=MeshConfig(data=1, particle=4)
    )
    psvo = dataclasses.replace(
        preset("lorenz63_psvo_k1024"), mesh=MeshConfig(data=1, particle=4)
    )
    b128 = preset(PRIMARY)
    b128 = dataclasses.replace(
        b128,
        name="fhn_fivo_k1024_b128",
        data=dataclasses.replace(b128.data, n_train=256),
        train=dataclasses.replace(b128.train, batch_size=128),
        mesh=MeshConfig(data=4, particle=1),
    )
    return [shrink(c) for c in (l96, psvo, b128)]


def phase_multi(cfg, devices, n_time: int = 5) -> str:
    """Loss and gradients of the objective sharded over `devices` against one
    card, and the time of that loss-and-gradient step on both. The mesh
    context is what makes the traced step sharded (the train step adds only
    the replicated Adam update), so one compile per side covers both the
    comparison and the timing."""
    import jax

    from psvo_tpu.benchmark import grads_agree, time_loop
    from psvo_tpu.parallel import context, sharding

    single = dataclasses.replace(
        cfg, mesh=dataclasses.replace(cfg.mesh, data=1, particle=1)
    )
    _, obj, params, key, ys, _ = _setup(single, with_noise=False)
    vg = jax.value_and_grad(lambda p, k, y: obj(p, k, y).loss)
    with jax.default_device(devices[0]):
        f1 = jax.jit(vg)
        v1, g1 = f1(params, key, ys)
        t1 = time_loop(lambda: f1(params, key, ys), n_time)

    mesh = sharding.make_mesh(cfg, devices)
    try:
        context.set_mesh(mesh)
        args = (
            sharding.place_replicated(mesh, params), key,
            jax.device_put(ys, sharding.batch_sharding(mesh)),
        )
        f4 = jax.jit(vg)
        v4, g4 = f4(*args)
        t4 = time_loop(lambda: f4(*args), n_time)
    finally:
        context.set_mesh(None)
    ok, detail = grads_agree(-float(v4), -float(v1), g4, g1, f"multi {cfg.name}")
    log(
        f"[multi] {cfg.name} mesh data={cfg.mesh.data} x particle={cfg.mesh.particle} "
        f"K={cfg.smc.n_particles} B={cfg.train.batch_size}: {detail}; "
        f"loss+gradient step {t4 * 1e3} ms on {len(devices)} cards vs {t1 * 1e3} ms "
        f"on one | {card()}"
    )
    if not ok:
        raise AssertionError(f"{cfg.name}: sharded run disagrees with one card: {detail}")
    return detail


# ---------------------------------------------------------------------------


def final_line(devices) -> str:
    d = devices[0]
    return json.dumps(
        {"ok": True, "device": {"platform": d.platform, "kind": d.device_kind,
                                "count": len(devices)}}
    )


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument(
        "--multi", action="store_true",
        help="run only the four-card mesh paths and their one-card comparisons",
    )
    args = ap.parse_args(argv)

    import jax

    devices = jax.devices()
    if devices[0].platform != "gpu":
        print(
            f"chip_smoke: no GPU — JAX's default platform is {devices[0].platform!r}",
            file=sys.stderr,
        )
        return 1
    t_start = time.perf_counter()
    log(f"[device] jax: {devices[0].device_kind} x{len(devices)} | nvidia-smi: {card()}")

    def timed(name, fn, *a):
        t0 = time.perf_counter()
        out = fn(*a)
        log(f"[time] {name} {time.perf_counter() - t0:.1f}s")
        return out

    if args.multi:
        if len(devices) < 4:
            raise SystemExit(f"--multi needs 4 GPUs, found {len(devices)}")
        for cfg in multi_configs():
            timed(f"multi {cfg.name}", phase_multi, cfg, devices[:4])
    else:
        from psvo_tpu.config import preset

        cpu = jax.devices("cpu")[0]
        timed("objectives", phase_objectives, one_card_configs())
        with tempfile.TemporaryDirectory() as tmp:
            run_dir = timed("train", phase_train, Path(tmp))
            timed("inference", phase_inference, run_dir)
        for name in (PRIMARY, "lorenz63_psvo_k1024"):
            timed(f"gpu-vs-cpu {name}", phase_gpu_vs_cpu, preset(name), (devices[0], cpu))
        timed("oracles", phase_oracles)
        timed("precision", phase_precision, preset(PRIMARY), devices[0])

    log(f"[done] all phases passed in {time.perf_counter() - t_start:.1f}s")
    log(f"[card] {card()}")
    print(final_line(devices), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
