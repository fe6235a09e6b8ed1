"""Multi-device tests on 8 virtual CPU devices (SURVEY.md §4.4): the real
Mesh/GSPMD code paths, asserting sharded-K results match single-device runs."""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from psvo_tpu.config import Config, DataConfig, MeshConfig, SMCConfig, TrainConfig
from psvo_tpu.models.ssm import init_ssm
from psvo_tpu.parallel import context, sharding
from psvo_tpu.smc import forward_filter

pytestmark = pytest.mark.skipif(
    len(jax.devices()) < 8, reason="needs 8 (virtual) devices"
)


@pytest.fixture(autouse=True)
def _reset_mesh():
    yield
    context.set_mesh(None)


def _cfg(d_data=2, d_part=4):
    return Config(
        name="shard_test",
        data=DataConfig(datatype="lorenz96", dx=8, dy=8, t_steps=6, n_train=4, n_test=2),
        smc=SMCConfig(objective="fivo", n_particles=32, resampling="systematic"),
        train=TrainConfig(batch_size=4),
        mesh=MeshConfig(data=d_data, particle=d_part),
    )


def test_dryrun_multichip():
    import __graft_entry__ as ge

    ge.dryrun_multichip(8)


def test_sharded_filter_matches_single_device():
    """Same keys, same data: the GSPMD-partitioned filter must reproduce the
    single-device numbers (reduction-order tolerance only)."""
    cfg = _cfg()
    ssm, params = init_ssm(cfg, jax.random.key(0))
    ys = jax.random.normal(jax.random.key(1), (4, cfg.data.t_steps, cfg.data.dy))

    run = jax.jit(
        lambda p, k, y: forward_filter(ssm, p, k, y, cfg.smc, cache=True).log_z
    )
    ref = np.asarray(run(params, jax.random.key(2), ys))

    mesh = sharding.make_mesh(cfg)
    context.set_mesh(mesh)
    ys_sh = jax.device_put(ys, sharding.batch_sharding(mesh))
    got = np.asarray(
        jax.jit(
            lambda p, k, y: forward_filter(ssm, p, k, y, cfg.smc, cache=True).log_z
        )(params, jax.random.key(2), ys_sh)
    )
    context.set_mesh(None)
    np.testing.assert_allclose(got, ref, rtol=2e-4, atol=2e-4)


def test_sharded_training_converges():
    """Several sharded steps must actually LEARN (loss decreasing), not just
    execute — guards against silent sharding-induced gradient corruption."""
    from psvo_tpu.data import generate_dataset
    from psvo_tpu.train import make_optimizer

    cfg = _cfg()
    ds = generate_dataset(cfg.data, cfg.seed)
    ssm, params = init_ssm(cfg, jax.random.key(0))
    optimizer = make_optimizer(cfg)
    opt_state = optimizer.init(params)
    mesh = sharding.make_mesh(cfg)
    step = sharding.make_sharded_train_step(ssm, cfg, optimizer, mesh)
    batch = jnp.asarray(ds.obs_train[: cfg.train.batch_size])
    losses = []
    p, s = params, opt_state
    for i in range(12):
        p, s, m = step(p, s, jax.random.fold_in(jax.random.key(2), i), batch)
        losses.append(float(m["loss"]))
    context.set_mesh(None)
    assert all(np.isfinite(l) for l in losses)
    assert np.mean(losses[-3:]) < np.mean(losses[:3]), losses


def test_cli_sharded_end_to_end(tmp_path, capsys):
    """The reference's capability bar is 'run the experiment from the CLI'
    (SURVEY.md §3.1): the sharded preset must build its mesh and train AND
    eval through `cli train`, end to end, on the 8 virtual devices."""
    from psvo_tpu import cli

    rc = cli.main(
        [
            "train",
            "--preset", "lorenz96_fivo_k8192_sharded",
            "--steps", "6",
            "--set", "smc.n_particles=32",
            "--set", "data.dx=8", "--set", "data.dy=8",
            "--set", "data.t_steps=6",
            "--set", "data.n_train=8", "--set", "data.n_test=4",
            "--set", "train.batch_size=4",
            "--set", "train.eval_every=3", "--set", "train.save_every=100",
            "--results-root", str(tmp_path),
        ]
    )
    context.set_mesh(None)
    assert rc == 0
    out = capsys.readouterr().out
    assert "mesh: data=1 x particle=4" in out  # the mesh was actually built
    assert "test_elbo" in out  # sharded eval ran
    runs = list(tmp_path.iterdir())
    assert runs and (runs[0] / "history.json").exists()


def test_sharded_train_with_controls():
    """Control inputs shard over the data axis alongside the batch."""
    from psvo_tpu.data import generate_dataset
    from psvo_tpu.train import make_optimizer

    cfg = _cfg()
    cfg = dataclasses.replace(
        cfg, data=dataclasses.replace(cfg.data, di=2)
    )
    ds = generate_dataset(cfg.data, cfg.seed)
    ssm, params = init_ssm(cfg, jax.random.key(0))
    optimizer = make_optimizer(cfg)
    opt_state = optimizer.init(params)
    mesh = sharding.make_mesh(cfg)
    step = sharding.make_sharded_train_step(ssm, cfg, optimizer, mesh)
    batch = jnp.asarray(ds.obs_train[: cfg.train.batch_size])
    ctrl = jnp.asarray(ds.controls_train[: cfg.train.batch_size])
    p2, _, metrics = step(params, opt_state, jax.random.key(2), batch, None, ctrl)
    context.set_mesh(None)
    assert np.isfinite(float(metrics["loss"]))


def test_eval_step_sharded():
    """Sharded eval: same metrics as the single-device eval step."""
    from psvo_tpu.train import make_eval_step

    cfg = _cfg()
    ssm, params = init_ssm(cfg, jax.random.key(0))
    ys = jax.random.normal(jax.random.key(1), (4, cfg.data.t_steps, cfg.data.dy))
    ref = make_eval_step(ssm, cfg)(params, jax.random.key(2), ys)

    mesh = sharding.make_mesh(cfg)
    ev = sharding.make_sharded_eval_step(ssm, cfg, mesh)(
        params, jax.random.key(2), ys
    )
    context.set_mesh(None)
    np.testing.assert_allclose(
        float(ev["elbo"]), float(ref["elbo"]), rtol=2e-4, atol=2e-4
    )
    np.testing.assert_allclose(
        np.asarray(ev["r2_k"]), np.asarray(ref["r2_k"]), rtol=2e-4, atol=2e-4
    )


def test_sharded_hlo_collectives():
    """The sharded filter's HLO must (a) psum the per-step weight normalizer
    (all-reduce), (b) exchange particles via the shard_map ring
    (collective-permute), and (c) NEVER all-gather the full [B, D, K]
    particle tensor — the GSPMD default this round replaced (a verified
    `f32[2,8,256] all-gather` per step before ops/sharded_resampling.py)."""
    import re

    cfg = _cfg()
    k = cfg.smc.n_particles
    ssm, params = init_ssm(cfg, jax.random.key(0))
    mesh = sharding.make_mesh(cfg)
    context.set_mesh(mesh)
    ys = jax.device_put(
        jax.random.normal(jax.random.key(1), (4, cfg.data.t_steps, cfg.data.dy)),
        sharding.batch_sharding(mesh),
    )
    f = jax.jit(lambda p, key, y: forward_filter(ssm, p, key, y, cfg.smc).log_z.sum())
    txt = f.lower(params, jax.random.key(2), ys).compile().as_text()
    context.set_mesh(None)

    assert "all-reduce" in txt  # the psum normalizer/ESS
    assert "collective-permute" in txt  # the particle ring
    # no all-gather may produce a tensor carrying the FULL particle axis
    # alongside a state axis (i.e. a replicated [*, D, K] particle tensor)
    for shape in re.findall(r"= (\w+\[[\d,]*\])[^\n]*all-gather\(", txt):
        dims = [int(d) for d in shape[shape.index("[") + 1 : -1].split(",") if d]
        assert not (len(dims) >= 3 and dims[-1] == k), (
            f"full particle tensor all-gathered: {shape}"
        )


def test_sharded_checkpoint_roundtrip(tmp_path):
    """Checkpoint written from a mesh run restores bit-equal into (a) a fresh
    single-device run and (b) a new mesh run."""
    from psvo_tpu.train import TrainState, make_optimizer
    from psvo_tpu.utils.checkpoint import Checkpointer

    cfg = _cfg()
    ssm, params = init_ssm(cfg, jax.random.key(0))
    optimizer = make_optimizer(cfg)
    opt_state = optimizer.init(params)
    mesh = sharding.make_mesh(cfg)
    step_fn = sharding.make_sharded_train_step(ssm, cfg, optimizer, mesh)
    batch = jax.random.normal(jax.random.key(1), (4, cfg.data.t_steps, cfg.data.dy))
    params, opt_state, _ = step_fn(params, opt_state, jax.random.key(2), batch)
    context.set_mesh(None)

    st = TrainState(params=params, opt_state=opt_state, key=jax.random.key(3), step=1)
    Checkpointer(tmp_path / "ck", "h1").save(st, force=True)

    # (a) restore into a single-device template from a *different* init
    _, params_b = init_ssm(cfg, jax.random.key(9))
    st_b = TrainState(
        params=params_b, opt_state=optimizer.init(params_b), key=jax.random.key(4)
    )
    restored = Checkpointer(tmp_path / "ck", "h1").restore(st_b)
    assert restored is not None and restored.step == 1
    for a, b in zip(
        jax.tree_util.tree_leaves(params),
        jax.tree_util.tree_leaves(restored.params),
    ):
        np.testing.assert_array_equal(np.asarray(a), np.asarray(b))

    # (b) the restored state drives a fresh mesh run (after the explicit
    # re-placement Trainer.restore performs under a mesh)
    re_params = sharding.place_replicated(mesh, restored.params)
    re_opt = sharding.place_replicated(mesh, restored.opt_state)
    step_fn2 = sharding.make_sharded_train_step(ssm, cfg, optimizer, mesh)
    _, _, metrics = step_fn2(re_params, re_opt, jax.random.key(5), batch)
    assert np.isfinite(float(metrics["loss"]))
    context.set_mesh(None)


def test_particle_mesh_segmented_ffbsi_matches_single_device():
    """Segmented long-T PSVO under a particle mesh (the last mesh × feature
    exclusion, closed round 3): each segment's reverse sweep (and the t=0
    step, as a length-1 sweep) runs through the ops/sharded_ffbsi.py island
    with accumulators chained across segments, and the per-segment forward
    recompute dispatches its resample to the sharded island automatically.
    Must reproduce the single-device segmented loss and gradients."""
    from psvo_tpu.objectives import make_objective

    cfg = _cfg()  # data=2, particle=4
    cfg = dataclasses.replace(
        cfg,
        data=dataclasses.replace(cfg.data, t_steps=7),  # T-1 = 6 = 2 segments
        smc=dataclasses.replace(
            cfg.smc,
            objective="psvo",
            ffbsi_segments=2,
            n_smoothing_particles=4,
        ),
    )
    ssm, params = init_ssm(cfg, jax.random.key(0))
    obj = make_objective(ssm, cfg)
    ys = jax.random.normal(jax.random.key(1), (4, cfg.data.t_steps, cfg.data.dy))
    ref_loss, ref_grad = jax.jit(
        jax.value_and_grad(lambda p, key, y: obj(p, key, y).loss)
    )(params, jax.random.key(2), ys)

    mesh = sharding.make_mesh(cfg)
    obj_sh = make_objective(ssm, cfg)
    context.set_mesh(mesh)
    ys_sh = jax.device_put(ys, sharding.batch_sharding(mesh))
    got_loss, got_grad = jax.jit(
        jax.value_and_grad(lambda p, key, y: obj_sh(p, key, y).loss)
    )(params, jax.random.key(2), ys_sh)
    context.set_mesh(None)

    assert np.isfinite(float(ref_loss))
    np.testing.assert_allclose(float(got_loss), float(ref_loss), rtol=2e-4)
    for a, b in zip(
        jax.tree_util.tree_leaves(ref_grad), jax.tree_util.tree_leaves(got_grad)
    ):
        np.testing.assert_allclose(
            np.asarray(b), np.asarray(a), rtol=2e-3, atol=2e-5
        )


@pytest.mark.parametrize("objective,d_data,d_part", [("fivo", 2, 4), ("psvo", 4, 1)])
def test_sharded_train_step_runs(objective, d_data, d_part):
    from psvo_tpu.train import make_optimizer

    cfg = _cfg(d_data=d_data, d_part=d_part)
    cfg = dataclasses.replace(
        cfg, smc=dataclasses.replace(cfg.smc, objective=objective)
    )
    ssm, params = init_ssm(cfg, jax.random.key(0))
    optimizer = make_optimizer(cfg)
    opt_state = optimizer.init(params)
    mesh = sharding.make_mesh(cfg)
    step = sharding.make_sharded_train_step(ssm, cfg, optimizer, mesh)
    batch = jax.random.normal(jax.random.key(1), (4, cfg.data.t_steps, cfg.data.dy))
    params2, _, metrics = step(params, opt_state, jax.random.key(2), batch)
    assert np.isfinite(float(metrics["loss"]))
    # params actually moved
    delta = sum(
        float(jnp.sum(jnp.abs(a - b)))
        for a, b in zip(
            jax.tree_util.tree_leaves(params), jax.tree_util.tree_leaves(params2)
        )
    )
    assert delta > 0
    context.set_mesh(None)


def _smooth_cfg(objective, d_data=2, d_part=4, m=4):
    cfg = _cfg(d_data, d_part)
    return dataclasses.replace(
        cfg,
        smc=dataclasses.replace(
            cfg.smc, objective=objective, n_smoothing_particles=m
        ),
    )


@pytest.mark.parametrize("objective", ["psvo", "svo"])
def test_sharded_smoothing_matches_single_device(objective):
    """Particle-sharded smoothing (ops/sharded_ffbsi.py island): the full
    objective — forward filter + backward sweep — must reproduce the
    single-device values AND parameter gradients (same keys; the backward
    draws consume the same pre-generated Gumbel noise, so the sampled
    trajectories are identical up to reduction-order float noise)."""
    from psvo_tpu.objectives import make_objective

    cfg = _smooth_cfg(objective)
    ssm, params = init_ssm(cfg, jax.random.key(0))
    obj = make_objective(ssm, cfg)
    ys = jax.random.normal(jax.random.key(1), (4, cfg.data.t_steps, cfg.data.dy))

    def loss_fn(p, key, y):
        return obj(p, key, y).loss

    ref_loss, ref_grad = jax.jit(jax.value_and_grad(loss_fn))(
        params, jax.random.key(2), ys
    )
    ref_loss = float(ref_loss)

    mesh = sharding.make_mesh(cfg)
    obj_sh = make_objective(ssm, cfg)
    context.set_mesh(mesh)
    ys_sh = jax.device_put(ys, sharding.batch_sharding(mesh))
    got_loss, got_grad = jax.jit(
        jax.value_and_grad(lambda p, key, y: obj_sh(p, key, y).loss)
    )(params, jax.random.key(2), ys_sh)
    context.set_mesh(None)

    assert np.isfinite(ref_loss)
    np.testing.assert_allclose(float(got_loss), ref_loss, rtol=2e-4)
    for a, b in zip(
        jax.tree_util.tree_leaves(ref_grad), jax.tree_util.tree_leaves(got_grad)
    ):
        np.testing.assert_allclose(
            np.asarray(b), np.asarray(a), rtol=2e-3, atol=2e-5
        )


def test_sharded_psvo_hlo_no_full_allgather():
    """The compiled particle-sharded PSVO program (forward + FFBSi backward)
    must not all-gather any tensor carrying the full particle axis — the
    GSPMD default the sharded_ffbsi island replaces."""
    import re

    from psvo_tpu.objectives import make_objective

    cfg = _smooth_cfg("psvo")
    k = cfg.smc.n_particles
    ssm, params = init_ssm(cfg, jax.random.key(0))
    mesh = sharding.make_mesh(cfg)
    obj = make_objective(ssm, cfg)
    context.set_mesh(mesh)
    ys = jax.device_put(
        jax.random.normal(jax.random.key(1), (4, cfg.data.t_steps, cfg.data.dy)),
        sharding.batch_sharding(mesh),
    )
    f = jax.jit(jax.grad(lambda p, key, y: obj(p, key, y).loss))
    txt = f.lower(params, jax.random.key(2), ys).compile().as_text()
    context.set_mesh(None)

    assert "collective-permute" in txt  # forward resampling ring still active
    for shape in re.findall(r"= (\w+\[[\d,]*\])[^\n]*all-gather\(", txt):
        dims = [int(d) for d in shape[shape.index("[") + 1 : -1].split(",") if d]
        assert not (len(dims) >= 3 and dims[-1] == k), (
            f"full particle tensor all-gathered: {shape}"
        )


def test_sharded_smoothing_train_step():
    """End-to-end: several sharded PSVO train steps over data×particle.

    Deliberately loops with recycled outputs: the second call compiles for
    NamedSharding inputs and the third re-dispatches that cached executable
    through jax's C++ fastpath — the path that broke when a module-level
    jnp constant became a hidden 183rd executable argument ("supplied 181
    buffers but expected 182", round-3 bisect in ops/sharded_ffbsi.py)."""
    from psvo_tpu.train import make_optimizer

    cfg = _smooth_cfg("psvo")
    ssm, params = init_ssm(cfg, jax.random.key(0))
    optimizer = make_optimizer(cfg)
    opt_state = optimizer.init(params)
    mesh = sharding.make_mesh(cfg)
    step = sharding.make_sharded_train_step(ssm, cfg, optimizer, mesh)
    batch = jax.random.normal(jax.random.key(1), (4, cfg.data.t_steps, cfg.data.dy))
    params0 = params
    for i in range(3):
        params, opt_state, metrics = step(
            params, opt_state, jax.random.key(2 + i), batch
        )
        jax.block_until_ready((params, opt_state))
        assert np.isfinite(float(metrics["loss"]))
    delta = sum(
        float(jnp.sum(jnp.abs(a - b)))
        for a, b in zip(
            jax.tree_util.tree_leaves(params0), jax.tree_util.tree_leaves(params)
        )
    )
    assert delta > 0
    context.set_mesh(None)


def test_maybe_mesh_raises_on_too_few_devices():
    """A sharded preset runs sharded or not at all: a mesh larger than the
    device count raises instead of silently running unsharded."""
    cfg = _cfg(d_data=4, d_part=4)  # 16 > 8 devices
    with pytest.raises(ValueError, match="needs 16 devices"):
        sharding.maybe_mesh(cfg)


def test_maybe_mesh_single_device_and_full_mesh():
    assert sharding.maybe_mesh(_cfg(d_data=1, d_part=1)) is None
    mesh = sharding.maybe_mesh(_cfg(d_data=1, d_part=4))
    assert dict(mesh.shape) == {context.DATA_AXIS: 1, context.PARTICLE_AXIS: 4}
