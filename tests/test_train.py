"""Trainer integration: short runs must improve the ELBO; eval/R², checkpoint
round-trip, CLI smoke (SURVEY.md §4.5)."""

import dataclasses
import json

import jax
import jax.numpy as jnp
import numpy as np
import pytest

_FAST = pytest.mark.fast  # <2 min verification subset

from psvo_tpu.config import Config, DataConfig, SMCConfig, TrainConfig
from psvo_tpu.data import generate_dataset
from psvo_tpu.models.ssm import init_ssm
from psvo_tpu.train import Trainer, make_eval_step


def _cfg(objective="fivo", k=32, steps=40):
    return Config(
        name=f"train_test_{objective}",
        seed=0,
        data=DataConfig(
            datatype="fhn", dx=2, dy=2, t_steps=25, n_train=24, n_test=8, obs_scale=0.3
        ),
        smc=SMCConfig(
            objective=objective, n_particles=k, n_smoothing_particles=4,
            resampling="none" if objective == "iwae" else "systematic",
        ),
        train=TrainConfig(lr=3e-3, batch_size=8, n_steps=steps, eval_every=steps // 2),
    )


@pytest.mark.parametrize(
    "objective",
    [pytest.param("fivo", marks=_FAST), "svo", "psvo"],  # fast: one smoke
)
def test_short_training_improves_elbo(objective):
    cfg = _cfg(objective, steps=30 if objective != "fivo" else 40)
    ds = generate_dataset(cfg.data, cfg.seed)
    ssm, params = init_ssm(cfg, jax.random.key(cfg.seed))

    ev = make_eval_step(ssm, cfg)
    before = float(ev(params, jax.random.key(7), ds.obs_test)["elbo"])
    trainer = Trainer(cfg, ssm, params)
    trainer.run(ds.obs_train, ds.obs_test)
    after = float(ev(trainer.state.params, jax.random.key(7), ds.obs_test)["elbo"])
    assert after > before, (before, after)
    # objective-specific bound extras persist to the eval record (a user
    # comparing PSVO's forward vs direct bound reads metrics.jsonl)
    rec = trainer.history[-1]
    if objective == "psvo":
        assert np.isfinite(rec["elbo_psvo_direct"])
        assert np.isfinite(rec["log_joint_smoothed"])
    if objective == "svo":
        assert np.isfinite(rec["elbo_svo"])


def test_steps_per_call_is_bit_identical_to_single_steps():
    """steps_per_call folds N steps into one jitted lax.scan but walks the
    SAME host-side key-split chain and minibatch-sampling sequence, so the
    trained params must be bit-identical to the N=1 path."""
    base = _cfg("fivo", steps=8)
    base = dataclasses.replace(
        base, train=dataclasses.replace(base.train, eval_every=4)
    )
    ds = generate_dataset(base.data, base.seed)
    ssm, params = init_ssm(base, jax.random.key(base.seed))

    results = {}
    for spc in (1, 4):
        cfg = dataclasses.replace(
            base, train=dataclasses.replace(base.train, steps_per_call=spc)
        )
        tr = Trainer(cfg, ssm, params)
        tr.run(ds.obs_train, ds.obs_test)
        results[spc] = tr.state.params
        assert tr.state.step == 8
    for a, b in zip(
        jax.tree_util.tree_leaves(results[1]), jax.tree_util.tree_leaves(results[4])
    ):
        np.testing.assert_array_equal(np.asarray(a), np.asarray(b))

    # cadence misalignment is rejected loudly
    bad = dataclasses.replace(
        base, train=dataclasses.replace(base.train, steps_per_call=3)
    )
    with pytest.raises(ValueError, match="multiple of"):
        Trainer(bad, ssm, params).run(ds.obs_train, ds.obs_test)


def test_debug_checks_flags_nonfinite_and_passes_clean():
    """SURVEY.md §5 sanitizers row: checkify float checks on the train step.
    A clean step must pass its error through silently; NaN-poisoned params
    must raise with float-check provenance on throw."""
    from jax.experimental import checkify

    from psvo_tpu.train import make_optimizer, make_train_step

    cfg = _cfg("fivo", steps=2)
    cfg = dataclasses.replace(
        cfg, train=dataclasses.replace(cfg.train, debug_checks=True)
    )
    ds = generate_dataset(cfg.data, cfg.seed)
    ssm, params = init_ssm(cfg, jax.random.key(0))
    opt = make_optimizer(cfg)
    step = make_train_step(ssm, cfg, opt)
    batch = jnp.asarray(ds.obs_train[: cfg.train.batch_size])

    p, s, m = step(params, opt.init(params), jax.random.key(1), batch)
    err = m.pop("checkify_err")
    checkify.check_error(err)  # clean run: no-op
    assert np.isfinite(float(m["loss"]))

    bad = jax.tree_util.tree_map(lambda a: a * jnp.nan, params)
    _, _, m_bad = step(bad, opt.init(bad), jax.random.key(1), batch)
    with pytest.raises(Exception) as ei:
        checkify.check_error(m_bad.pop("checkify_err"))
    assert "nan" in str(ei.value).lower()


def test_eval_metrics_shapes():
    cfg = _cfg("fivo")
    ds = generate_dataset(cfg.data, cfg.seed)
    ssm, params = init_ssm(cfg, jax.random.key(0))
    ev = make_eval_step(ssm, cfg)(params, jax.random.key(1), ds.obs_test)
    assert ev["r2_k"].shape == (cfg.train.mse_k_steps,)
    assert ev["mse_k"].shape == (cfg.train.mse_k_steps,)
    assert np.isfinite(float(ev["elbo"]))


def test_checkpoint_roundtrip(tmp_path):
    from psvo_tpu.train import TrainState, make_optimizer
    from psvo_tpu.utils.checkpoint import Checkpointer

    cfg = _cfg("fivo")
    ssm, params = init_ssm(cfg, jax.random.key(0))
    opt = make_optimizer(cfg)
    best = jax.tree_util.tree_map(lambda a: a + 1.0, params)
    state = TrainState(params, opt.init(params), jax.random.key(5), step=17,
                       best_elbo=-3.5, evals_since_best=2, best_params=best)
    ck = Checkpointer(tmp_path / "ck", cfg.config_hash())
    ck.save(state, force=True)

    fresh = TrainState(
        jax.tree_util.tree_map(lambda a: a * 0, params), opt.init(params),
        jax.random.key(0),
    )
    ck2 = Checkpointer(tmp_path / "ck", cfg.config_hash())
    restored = ck2.restore(fresh)
    assert restored.step == 17
    assert restored.best_elbo == pytest.approx(-3.5)
    assert restored.evals_since_best == 2
    for a, b in zip(
        jax.tree_util.tree_leaves(params), jax.tree_util.tree_leaves(restored.params)
    ):
        np.testing.assert_array_equal(np.asarray(a), np.asarray(b))
    # best_params travels with best_elbo: a resumed keep_best run must be able
    # to end on the best snapshot, not the last params
    assert restored.best_params is not None
    for a, b in zip(
        jax.tree_util.tree_leaves(best),
        jax.tree_util.tree_leaves(restored.best_params),
    ):
        np.testing.assert_array_equal(np.asarray(a), np.asarray(b))
    # a state saved WITHOUT a best snapshot restores best_params=None
    state_nb = TrainState(params, opt.init(params), jax.random.key(5), step=18)
    ck.save(state_nb, force=True)
    restored_nb = Checkpointer(tmp_path / "ck", cfg.config_hash()).restore(
        TrainState(params, opt.init(params), jax.random.key(0))
    )
    assert restored_nb.best_params is None
    # wrong config hash must refuse
    with pytest.raises(ValueError):
        Checkpointer(tmp_path / "ck", "deadbeef0000").restore(fresh)

    # params-only restore (eval path): independent of optimizer structure
    restored_params = Checkpointer(tmp_path / "ck", cfg.resume_hash()).restore_params(
        jax.tree_util.tree_map(lambda a: a * 0, params)
    )
    for a, b in zip(
        jax.tree_util.tree_leaves(params), jax.tree_util.tree_leaves(restored_params)
    ):
        np.testing.assert_array_equal(np.asarray(a), np.asarray(b))


def test_cli_presets_and_config_roundtrip(capsys):
    from psvo_tpu import cli
    from psvo_tpu.config import from_dict, preset

    assert cli.main(["presets"]) == 0
    out = capsys.readouterr().out
    assert "fhn_fivo_k128" in out

    cfg = preset("lorenz63_psvo_k1024")
    cfg2 = from_dict(json.loads(json.dumps(cfg.to_dict())))
    assert cfg2 == cfg
    assert cfg2.config_hash() == cfg.config_hash()


@_FAST
def test_cli_eval_prints_both_psvo_bounds(capsys):
    """`cli eval` on a PSVO config must surface BOTH bound forms — the
    reported forward (Rao-Blackwellized) `elbo` and the reference-form
    `elbo_psvo_direct` — in the JSON output and the summary line."""
    from psvo_tpu import cli

    rc = cli.main(
        [
            "eval",
            "--preset",
            "lorenz63_psvo_k1024",
            "--set",
            "smc.n_particles=16",
            "--set",
            "smc.n_smoothing_particles=4",
            "--set",
            "data.t_steps=10",
            "--set",
            "data.n_train=4",
            "--set",
            "data.n_test=3",
        ]
    )
    assert rc == 0
    cap = capsys.readouterr()
    out = json.loads(cap.out)
    assert "elbo" in out and "elbo_psvo_direct" in out
    assert np.isfinite(out["elbo"]) and np.isfinite(out["elbo_psvo_direct"])
    assert "PSVO bounds" in cap.err


def test_cli_override():
    from psvo_tpu.cli import apply_overrides
    from psvo_tpu.config import preset

    cfg = apply_overrides(
        preset("fhn_fivo_k128"), ["smc.n_particles=64", "train.lr=0.001"]
    )
    assert cfg.smc.n_particles == 64
    assert cfg.train.lr == 0.001
    with pytest.raises(SystemExit):
        apply_overrides(preset("fhn_fivo_k128"), ["smc.nope=1"])


def test_data_generation_properties():
    cfg = DataConfig(datatype="lorenz63", dx=3, dy=3, t_steps=50, n_train=6, n_test=3)
    ds = generate_dataset(cfg, 0)
    assert ds.obs_train.shape == (6, 50, 3)
    assert ds.hidden_test.shape == (3, 50, 3)
    # burn-in puts trajectories on the attractor: bounded, non-trivial variance
    h = np.asarray(ds.hidden_train)
    assert np.all(np.abs(h) < 60)
    assert h.std() > 1.0
    ds2 = generate_dataset(cfg, 0)
    np.testing.assert_array_equal(np.asarray(ds.obs_train), np.asarray(ds2.obs_train))
    ds3 = generate_dataset(cfg, 1)
    assert not np.allclose(np.asarray(ds.obs_train), np.asarray(ds3.obs_train))


def test_q_uses_true_x_debug_mode():
    """The debug flag trains and evals with the encoder conditioned on the
    true latents (mismatched-din and eval-input bugs are regression-guarded:
    dx != dy here, and eval must receive hidden_test)."""
    cfg = Config(
        name="true_x_test",
        data=DataConfig(
            datatype="lorenz63", dx=3, dy=3, t_steps=15, n_train=8, n_test=4
        ),
        smc=SMCConfig(objective="fivo", n_particles=16, q_uses_true_x=True),
        train=TrainConfig(batch_size=4, n_steps=6, eval_every=3),
    )
    ds = generate_dataset(cfg.data, 0)
    ssm, params = init_ssm(cfg, jax.random.key(0))
    trainer = Trainer(cfg, ssm, params)
    with pytest.raises(ValueError):
        trainer.run(ds.obs_train, ds.obs_test)  # latents are required
    hist = Trainer(cfg, ssm, params).run(
        ds.obs_train, ds.obs_test,
        hidden_train=ds.hidden_train, hidden_test=ds.hidden_test,
    )
    assert np.isfinite(hist[-1]["test_elbo"])


def test_filtered_means_emitted_without_cache():
    """Eval path: filtering means come from the scan, no particle cache."""
    from psvo_tpu.smc import forward_filter
    from psvo_tpu.train import filtered_means

    cfg = _cfg("fivo")
    ds = generate_dataset(cfg.data, 0)
    ssm, params = init_ssm(cfg, jax.random.key(0))
    fwd = forward_filter(
        ssm, params, jax.random.key(1), jnp.asarray(ds.obs_test), cfg.smc, cache=True
    )
    assert fwd.filtered_means is not None and fwd.xs is not None
    # emitted means must equal the cache-derived means
    import jax.numpy as jnp2

    logw_norm = fwd.logws - jax.scipy.special.logsumexp(
        fwd.logws, axis=-1, keepdims=True
    )
    want = jnp2.swapaxes(
        jnp2.einsum("tbk,tbdk->tbd", jnp2.exp(logw_norm), fwd.xs), 0, 1
    )
    np.testing.assert_allclose(
        np.asarray(filtered_means(fwd)), np.asarray(want), rtol=1e-4, atol=1e-5
    )


def test_dataset_save_load_roundtrip(tmp_path):
    from psvo_tpu.data import load_dataset, save_dataset

    cfg = DataConfig(datatype="fhn", t_steps=10, n_train=4, n_test=2)
    ds = generate_dataset(cfg, 0)
    p = tmp_path / "ds.npz"
    save_dataset(ds, p)
    ds2 = load_dataset(p)
    np.testing.assert_array_equal(np.asarray(ds.obs_train), np.asarray(ds2.obs_train))
    np.testing.assert_array_equal(
        np.asarray(ds.hidden_test), np.asarray(ds2.hidden_test)
    )


def test_poisson_emission_pipeline():
    cfg = Config(
        name="poisson_test",
        data=DataConfig(
            datatype="fhn", dx=2, dy=2, t_steps=10, n_train=4, n_test=2,
            emission="poisson",
        ),
        smc=SMCConfig(objective="fivo", n_particles=16),
    )
    ds = generate_dataset(cfg.data, 0)
    assert np.all(np.asarray(ds.obs_train) >= 0)
    ssm, params = init_ssm(cfg, jax.random.key(0))
    from psvo_tpu.objectives import make_objective

    out = make_objective(ssm, cfg)(params, jax.random.key(1), ds.obs_train)
    assert np.isfinite(float(out.loss))


def test_checkpoint_pruning_and_atomic_write(tmp_path):
    """max_to_keep newest files survive; every save is renamed into place,
    so no temporary file is left behind; an empty directory restores None."""
    from psvo_tpu.train import TrainState, make_optimizer
    from psvo_tpu.utils.checkpoint import Checkpointer

    cfg = _cfg("fivo")
    ssm, params = init_ssm(cfg, jax.random.key(0))
    opt = make_optimizer(cfg)
    empty = Checkpointer(tmp_path / "none", "h")
    assert empty.restore(TrainState(params, opt.init(params), jax.random.key(0))) is None
    assert empty.restore_params(params) is None

    ck = Checkpointer(tmp_path / "ck", "h", max_to_keep=2)
    for step in (5, 10, 15, 20):
        ck.save(TrainState(params, opt.init(params), jax.random.key(step), step=step))
    assert ck.steps() == [15, 20]
    assert sorted(p.name for p in (tmp_path / "ck").iterdir()) == [
        "ckpt_0000000015.npz", "ckpt_0000000020.npz"
    ]
    restored = Checkpointer(tmp_path / "ck", "h").restore(
        TrainState(params, opt.init(params), jax.random.key(0))
    )
    assert restored.step == 20
    np.testing.assert_array_equal(
        np.asarray(jax.random.key_data(restored.key)),
        np.asarray(jax.random.key_data(jax.random.key(20))),
    )


def test_checkpoint_restores_rbg_keys(tmp_path):
    """The key is rebuilt with the template key's PRNG implementation."""
    from psvo_tpu.train import TrainState, make_optimizer
    from psvo_tpu.utils.checkpoint import Checkpointer

    cfg = _cfg("fivo")
    ssm, params = init_ssm(cfg, jax.random.key(0))
    opt = make_optimizer(cfg)
    key = jax.random.key(7, impl="rbg")
    Checkpointer(tmp_path, "h").save(TrainState(params, opt.init(params), key, step=3))
    got = Checkpointer(tmp_path, "h").restore(
        TrainState(params, opt.init(params), jax.random.key(0, impl="rbg"))
    )
    np.testing.assert_array_equal(
        np.asarray(jax.random.key_data(got.key)), np.asarray(jax.random.key_data(key))
    )
    assert jax.random.key_impl(got.key) == jax.random.key_impl(key)


@pytest.mark.parametrize("steps_per_call,epochs", [(1, 0), (2, 0), (1, 3)])
def test_trainer_resume_is_step_exact(tmp_path, steps_per_call, epochs):
    """A run stopped at step 4 and resumed to step 8 ends on the same params,
    optimizer state and key, bit for bit, as a run that never stopped."""
    from psvo_tpu.utils.checkpoint import Checkpointer

    base = _cfg("fivo", steps=8)
    cfg = dataclasses.replace(
        base,
        train=dataclasses.replace(
            base.train, eval_every=2, save_every=4, keep_best=False,
            steps_per_call=steps_per_call, epochs=epochs,
        ),
    )
    ds = generate_dataset(cfg.data, cfg.seed)
    ssm, params = init_ssm(cfg, jax.random.key(cfg.seed))
    n_total = 8 if not epochs else None

    straight = Trainer(cfg, ssm, params)
    straight.run(ds.obs_train, ds.obs_test, n_steps=n_total)

    first = Trainer(cfg, ssm, params, checkpointer=Checkpointer(tmp_path, cfg.resume_hash()))
    first.run(ds.obs_train, ds.obs_test, n_steps=4)
    resumed = Trainer(cfg, ssm, params, checkpointer=Checkpointer(tmp_path, cfg.resume_hash()))
    assert resumed.restore() == 4
    resumed.run(ds.obs_train, ds.obs_test, n_steps=n_total)

    assert resumed.state.step == straight.state.step
    for a, b in zip(
        jax.tree_util.tree_leaves((straight.state.params, straight.state.opt_state)),
        jax.tree_util.tree_leaves((resumed.state.params, resumed.state.opt_state)),
    ):
        np.testing.assert_array_equal(np.asarray(a), np.asarray(b))
    np.testing.assert_array_equal(
        np.asarray(jax.random.key_data(straight.state.key)),
        np.asarray(jax.random.key_data(resumed.state.key)),
    )
    assert [r["train_loss"] for r in straight.history[2:]] == [
        r["train_loss"] for r in resumed.history
    ]


def test_cli_trains_without_orbax_or_matplotlib(tmp_path):
    """Training, checkpointing and resuming need neither orbax nor
    matplotlib: with both unimportable the CLI trains 2 steps, resumes, says
    the plots were skipped and exits 0."""
    import subprocess
    import sys
    import textwrap

    script = textwrap.dedent(
        f"""
        import sys
        for name in ("orbax", "orbax.checkpoint", "matplotlib", "matplotlib.pyplot"):
            sys.modules[name] = None
        import jax
        jax.config.update("jax_platforms", "cpu")
        from psvo_tpu import cli
        args = ["train", "--preset", "fhn_fivo_k128",
                "--set", "smc.n_particles=8", "--set", "data.t_steps=5",
                "--set", "data.n_train=4", "--set", "data.n_test=2",
                "--set", "train.batch_size=2", "--set", "train.steps_per_call=1",
                "--set", "train.eval_every=1", "--set", "train.save_every=2"]
        root = {str(tmp_path)!r}
        assert cli.main(args + ["--steps", "2", "--results-root", root + "/a"]) == 0
        import pathlib
        (run,) = pathlib.Path(root, "a").iterdir()
        assert cli.main(args + ["--steps", "3", "--results-root", root + "/b",
                                "--resume", str(run / "checkpoints")]) == 0
        """
    )
    env = {k: v for k, v in __import__("os").environ.items() if k != "XLA_FLAGS"}
    r = subprocess.run(
        [sys.executable, "-c", script], capture_output=True, text=True, timeout=300,
        env=env, cwd=__import__("os").path.dirname(__import__("os").path.dirname(__file__)),
    )
    assert r.returncode == 0, r.stderr[-2000:]
    assert r.stdout.count("plots skipped: ") == 2
    assert "resumed from step 2" in r.stdout


@pytest.mark.parametrize("env_dir", [True, False])
def test_compile_cache_placement(tmp_path, env_dir):
    """JAX_COMPILATION_CACHE_DIR, when set, is left to JAX; otherwise the
    cache sits at <checkout>/.jax_cache."""
    import os
    import subprocess
    import sys

    repo = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    env = dict(os.environ)
    env["JAX_PLATFORMS"] = "cpu"
    env["PYTHONPATH"] = repo  # run from elsewhere: the path must not follow cwd
    env.pop("JAX_COMPILATION_CACHE_DIR", None)
    if env_dir:
        env["JAX_COMPILATION_CACHE_DIR"] = str(tmp_path / "mine")
    r = subprocess.run(
        [sys.executable, "-c",
         "import psvo_tpu, jax; print(jax.config.jax_compilation_cache_dir)"],
        capture_output=True, text=True, timeout=120, env=env, cwd=str(tmp_path),
    )
    assert r.returncode == 0, r.stderr
    want = str(tmp_path / "mine") if env_dir else os.path.join(repo, ".jax_cache")
    assert r.stdout.strip() == want
