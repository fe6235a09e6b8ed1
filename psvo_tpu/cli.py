"""Experiment driver CLI: train / eval / bench.

Covers the reference's `runner_flag.py` + `runner.py` (SURVEY.md §2-A/§3.1,
unverified paths): choose an experiment via flags, seed everything, generate
the dataset, build the model + objective, train, and save results/plots.

Usage:
    python -m psvo_tpu.cli train --preset fhn_fivo_k128 [--steps N] [--resume DIR]
    python -m psvo_tpu.cli eval  --preset ... --checkpoint DIR
    python -m psvo_tpu.cli bench --preset fhn_fivo_k1024_bench
    python -m psvo_tpu.cli presets

Every reference flag has a config-field equivalent (see psvo_tpu/config.py);
--set dotted.key=value overrides any field, e.g. --set smc.n_particles=512.
"""

from __future__ import annotations

import argparse
import dataclasses
import json
import sys

import jax
import jax.numpy as jnp
import numpy as np

from psvo_tpu.utils.rng import run_key
from psvo_tpu.config import PRESETS, Config, from_dict, preset


def apply_overrides(cfg: Config, sets: list[str]) -> Config:
    """Apply --set dotted.key=value overrides onto the config dataclass tree."""
    d = cfg.to_dict()
    for item in sets:
        key, _, raw = item.partition("=")
        if not raw:
            raise SystemExit(f"--set expects key=value, got {item!r}")
        node = d
        parts = key.split(".")
        for p in parts[:-1]:
            node = node[p]
        try:
            value = json.loads(raw)
        except json.JSONDecodeError:
            value = raw
        if parts[-1] not in node:
            raise SystemExit(f"unknown config key {key!r}")
        node[parts[-1]] = value
    return from_dict(d)


def build(cfg: Config, data_npz: str | None = None):
    from psvo_tpu.data import generate_dataset, load_dataset
    from psvo_tpu.models.ssm import init_ssm

    dataset = load_dataset(data_npz) if data_npz else generate_dataset(cfg.data, cfg.seed)
    ssm, params = init_ssm(cfg, run_key(cfg))
    return dataset, ssm, params


def _inferred_test_latents(cfg, ssm, params, dataset):
    """Posterior latent paths on the test set for the parity plots.

    Smoothing objectives plot the smoothed trajectories (mean over the M
    backward draws — what the reference's phase portraits show); filtering
    objectives plot the filtering means.
    """
    from psvo_tpu.objectives import make_objective
    from psvo_tpu.smc import forward_filter
    from psvo_tpu.train import filtered_means

    key = run_key(cfg, 9)
    obs = jnp.asarray(dataset.obs_test)
    # q_uses_true_x: the encoder heads were built with input dim Dx and must
    # see the true latents, mirroring Trainer.run (shape error — or silently
    # wrong plots when dx == dy — otherwise).
    enc = _encoder_inputs_for(cfg, dataset)
    ctrl = jnp.asarray(dataset.controls_test) if cfg.data.di else None
    if cfg.smc.objective in ("svo", "psvo"):
        out = make_objective(ssm, cfg)(params, key, obs, enc, ctrl)
        return np.asarray(jnp.swapaxes(out.smoothed.mean(axis=2), 0, 1))
    fwd = forward_filter(
        ssm, params, key, obs, cfg.smc, cache=True, encoder_inputs=enc, controls=ctrl
    )
    return np.asarray(filtered_means(fwd))


def _encoder_inputs_for(cfg: Config, dataset):
    """Test-set encoder inputs under the q_uses_true_x debug flag, else None."""
    if not cfg.smc.q_uses_true_x:
        return None
    if dataset.hidden_test is None:
        raise SystemExit("q_uses_true_x=True requires a dataset with saved latents")
    return jnp.asarray(dataset.hidden_test)


def cmd_train(args) -> int:
    if args.debug_nans:
        jax.config.update("jax_debug_nans", True)
    cfg = apply_overrides(preset(args.preset), args.set or [])
    if args.debug_checks:
        cfg = dataclasses.replace(
            cfg, train=dataclasses.replace(cfg.train, debug_checks=True)
        )
    if args.steps:
        cfg = dataclasses.replace(
            cfg, train=dataclasses.replace(cfg.train, n_steps=args.steps)
        )
    print(f"config: {cfg.name} (hash {cfg.config_hash()})", flush=True)

    dataset, ssm, params = build(cfg, args.data_npz)
    from psvo_tpu.parallel.sharding import maybe_mesh
    from psvo_tpu.train import Trainer
    from psvo_tpu.utils.checkpoint import Checkpointer
    from psvo_tpu.utils.metrics import MetricsWriter
    from psvo_tpu.utils.results import ResultsDir

    mesh = maybe_mesh(cfg)
    if mesh is not None:
        print(
            f"mesh: data={cfg.mesh.data} x particle={cfg.mesh.particle} "
            f"({mesh.devices.size} devices)",
            flush=True,
        )
    results = ResultsDir(args.results_root, cfg)
    print(f"results: {results.path}", flush=True)
    ckpt_dir = args.resume if args.resume else results.checkpoint_dir()
    trainer = Trainer(
        cfg,
        ssm,
        params,
        mesh=mesh,
        metrics_writer=MetricsWriter(results.metrics_path()),
        checkpointer=Checkpointer(ckpt_dir, cfg.resume_hash()),
        profile_dir=args.profile,
    )
    if args.resume:
        step = trainer.restore()
        print(f"resumed from step {step}", flush=True)

    history = trainer.run(
        dataset.obs_train,
        dataset.obs_test,
        hidden_train=dataset.hidden_train,
        hidden_test=dataset.hidden_test,
        controls_train=dataset.controls_train,
        controls_test=dataset.controls_test,
    )
    results.save_history(history)
    try:
        import matplotlib  # noqa: F401
    except ModuleNotFoundError as e:
        # plots are optional; results, metrics and checkpoints are written
        print(f"plots skipped: {e}", flush=True)
        return 0
    inferred = _inferred_test_latents(cfg, ssm, trainer.state.params, dataset)
    written = results.plot_all(history, dataset, inferred)
    print("plots:", *map(str, written), flush=True)
    return 0


def cmd_eval(args) -> int:
    cfg = apply_overrides(preset(args.preset), args.set or [])
    dataset, ssm, params = build(cfg)
    from psvo_tpu.train import TrainState, Trainer, make_eval_step
    from psvo_tpu.utils.checkpoint import Checkpointer

    if args.checkpoint:
        restored = Checkpointer(args.checkpoint, cfg.resume_hash()).restore_params(params)
        if restored is None:
            raise SystemExit(f"no checkpoint found in {args.checkpoint}")
        params = restored
    ev = make_eval_step(ssm, cfg)(
        params,
        run_key(cfg, 3),
        jnp.asarray(dataset.obs_test),
        _encoder_inputs_for(cfg, dataset),
        jnp.asarray(dataset.controls_test) if cfg.data.di else None,
    )
    out = {k: np.asarray(v).tolist() for k, v in ev.items()}
    if cfg.smc.objective == "psvo":
        # both PSVO bound forms, side by side: `elbo` is the
        # Rao-Blackwellized forward bound by documented choice; the
        # reference-form sampled-trajectory bound must be equally visible
        print(
            f"# PSVO bounds: forward (reported `elbo`) {out['elbo']:.3f} | "
            f"direct sampled-trajectory (`elbo_psvo_direct`) "
            f"{out['elbo_psvo_direct']:.3f} — see docs/DESIGN.md for the "
            "support-size offset between the two",
            file=sys.stderr,
        )
    print(json.dumps(out, indent=2))
    return 0


def cmd_bench(args) -> int:
    if args.to_target:
        from psvo_tpu.benchmark import main_to_target

        return main_to_target(args.preset, target_elbo=args.target_elbo)
    if args.all:
        from psvo_tpu.benchmark import main_all

        return main_all(steps=args.bench_steps)
    from psvo_tpu.benchmark import main as bench_main

    return bench_main(preset_name=args.preset, steps=args.bench_steps)


def cmd_data(args) -> int:
    """Generate a dataset from a preset's data config and save it as .npz."""
    from psvo_tpu.data import generate_dataset, save_dataset

    cfg = apply_overrides(preset(args.preset), args.set or [])
    ds = generate_dataset(cfg.data, cfg.seed)
    save_dataset(ds, args.out)
    print(f"saved {cfg.data.datatype} dataset ({cfg.data.n_train}+{cfg.data.n_test} "
          f"trajectories, T={cfg.data.t_steps}) to {args.out}")
    return 0


def cmd_presets(_args) -> int:
    for name, cfg in PRESETS.items():
        print(
            f"{name:32s} objective={cfg.smc.objective:5s} K={cfg.smc.n_particles:<6d}"
            f" data={cfg.data.datatype:8s} T={cfg.data.t_steps}"
        )
    return 0


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(prog="psvo_tpu", description=__doc__)
    sub = ap.add_subparsers(dest="cmd", required=True)

    p_train = sub.add_parser("train")
    p_train.add_argument("--preset", required=True, choices=sorted(PRESETS))
    p_train.add_argument("--steps", type=int, default=0)
    p_train.add_argument("--set", action="append", metavar="KEY=VALUE")
    p_train.add_argument("--results-root", default="results")
    p_train.add_argument("--resume", default=None, help="checkpoint dir to resume from")
    p_train.add_argument(
        "--debug-nans", action="store_true",
        help="enable jax_debug_nans (the rebuild's sanitizer mode, SURVEY.md §5)",
    )
    p_train.add_argument(
        "--debug-checks", action="store_true",
        help="run the train step under checkify float checks (compiled "
        "NaN/inf provenance — faster than --debug-nans)",
    )
    p_train.add_argument(
        "--profile", default=None, metavar="DIR",
        help="capture a jax.profiler trace of steady-state steps into DIR",
    )
    p_train.set_defaults(fn=cmd_train)

    p_eval = sub.add_parser("eval")
    p_eval.add_argument("--preset", required=True, choices=sorted(PRESETS))
    p_eval.add_argument("--set", action="append", metavar="KEY=VALUE")
    p_eval.add_argument("--checkpoint", default=None)
    p_eval.set_defaults(fn=cmd_eval)

    p_bench = sub.add_parser("bench")
    p_bench.add_argument("--preset", default="fhn_fivo_k1024_bench")
    p_bench.add_argument("--bench-steps", type=int, default=30)
    p_bench.add_argument("--all", action="store_true")
    p_bench.add_argument(
        "--to-target", action="store_true",
        help="train the preset to a fixed test ELBO; report wall-clock seconds",
    )
    p_bench.add_argument("--target-elbo", type=float, default=-15.0)
    p_bench.set_defaults(fn=cmd_bench)

    p_train.add_argument(
        "--data-npz", default=None, help="load a saved dataset instead of simulating"
    )

    p_data = sub.add_parser("data", help="generate + save a dataset (.npz)")
    p_data.add_argument("--preset", required=True, choices=sorted(PRESETS))
    p_data.add_argument("--set", action="append", metavar="KEY=VALUE")
    p_data.add_argument("--out", required=True)
    p_data.set_defaults(fn=cmd_data)

    p_presets = sub.add_parser("presets")
    p_presets.set_defaults(fn=cmd_presets)

    args = ap.parse_args(argv)
    return args.fn(args)


if __name__ == "__main__":
    sys.exit(main())
