"""ELBO-trajectory checks of the smoothing objectives against the trusted
NumPy reimplementations (SURVEY.md §4.2 / BASELINE.json numerics north star:
"a slow, trusted NumPy reimplementation of each objective").

The JAX and NumPy paths use independent RNGs, so the comparison is
statistical: estimator means over fixed-seed replicates must agree within
combined standard-error bands, on FHN and Lorenz-63 (the two reference
benchmark families).
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from psvo_tpu.config import Config, DataConfig, NetConfig, SMCConfig
from psvo_tpu.data import generate_dataset
from psvo_tpu.models.ssm import init_ssm
from psvo_tpu.objectives import make_objective
from tests.reference_numpy.numpy_smc import NumpySSMParams
from tests.reference_numpy.numpy_smoothing import (
    numpy_psvo_terms,
    numpy_svo_elbo,
)

K, M, T, B, REPS = 128, 8, 12, 4, 12


def _setup(datatype, objective, m=M, psvo_bound="forward", **data_kw):
    dx = 2 if datatype == "fhn" else 3
    net = NetConfig(hidden=(16, 16))
    cfg = Config(
        name=f"smoothing_ref_{datatype}",
        data=DataConfig(
            datatype=datatype, dx=dx, dy=dx, t_steps=T, n_train=B, n_test=B,
            **data_kw,
        ),
        smc=SMCConfig(
            objective=objective,
            n_particles=K,
            n_smoothing_particles=m,
            resampling="systematic",
            psvo_bound=psvo_bound,
        ),
    ).with_nets(
        q0=net, q1=net, q2=net, f=net,
        g=dataclasses.replace(net, sigma_init=0.5), qb=net,
    )
    ssm, params = init_ssm(cfg, jax.random.key(0))
    ds = generate_dataset(cfg.data, seed=1)
    ys = jnp.asarray(ds.obs_train[:B])
    return cfg, ssm, params, ys


def _bands(a, b):
    """Assert mean(a) ≈ mean(b) within combined 4·SE + 2% relative slack."""
    a, b = np.asarray(a), np.asarray(b)
    se = np.sqrt(a.var() / a.size + b.var() / b.size)
    tol = 4.0 * se + 0.02 * max(abs(a.mean()), abs(b.mean())) + 1e-3
    assert abs(a.mean() - b.mean()) < tol, (
        f"means {a.mean():.3f} vs {b.mean():.3f}, tol {tol:.3f}"
    )


@pytest.mark.parametrize("datatype,kw", [("fhn", {}), ("lorenz63", {"obs_scale": 0.5})])
def test_svo_bound_matches_numpy(datatype, kw):
    cfg, ssm, params, ys = _setup(datatype, "svo", **kw)
    obj = jax.jit(
        lambda key: jnp.mean(make_objective(ssm, cfg)(params, key, ys).elbo)
    )
    jax_vals = np.array([float(obj(jax.random.key(100 + r))) for r in range(REPS)])

    model = NumpySSMParams.from_jax(params, ssm)
    np_vals = np.array(
        [
            float(np.mean(numpy_svo_elbo(model, np.asarray(ys), K, M, seed=200 + 3 * r)))
            for r in range(REPS)
        ]
    )
    _bands(jax_vals, np_vals)


@pytest.mark.parametrize("datatype,kw", [("fhn", {}), ("lorenz63", {"obs_scale": 0.5})])
def test_psvo_terms_match_numpy(datatype, kw):
    """All three PSVO quantities: forward logZ, the smoothed-path log-joint
    (the EM surrogate), and the reference-form direct bound."""
    cfg, ssm, params, ys = _setup(datatype, "psvo", **kw)
    objective = make_objective(ssm, cfg)

    @jax.jit
    def run(key):
        out = objective(params, key, ys)
        return (
            jnp.mean(out.elbo),
            out.metrics["log_joint_smoothed"],
            out.metrics["elbo_psvo_direct"],
        )

    jax_vals = np.array(
        [[float(v) for v in run(jax.random.key(300 + r))] for r in range(REPS)]
    )

    model = NumpySSMParams.from_jax(params, ssm)
    np_vals = []
    for r in range(REPS):
        lz, lj, direct = numpy_psvo_terms(
            model, np.asarray(ys), K, M, seed=400 + 3 * r
        )
        np_vals.append([np.mean(lz), np.mean(lj), np.mean(direct)])
    np_vals = np.array(np_vals)

    for c, name in enumerate(["log_z_fwd", "log_joint_smoothed", "elbo_psvo_direct"]):
        _bands(jax_vals[:, c], np_vals[:, c])


def test_psvo_direct_bound_trainable():
    """psvo_bound='direct' (the reference-form objective) must train: a few
    steps on FHN improve the direct bound and keep everything finite."""
    from psvo_tpu.train import make_optimizer, make_train_step

    cfg, ssm, params, ys = _setup("fhn", "psvo")
    cfg = dataclasses.replace(
        cfg, smc=dataclasses.replace(cfg.smc, psvo_bound="direct")
    )
    ssm, params = init_ssm(cfg, jax.random.key(0))
    opt = make_optimizer(cfg)
    opt_state = opt.init(params)
    step = make_train_step(ssm, cfg, opt)
    first = last = None
    p = params
    for i in range(30):
        p, opt_state, metrics = step(p, opt_state, jax.random.key(500 + i), ys)
        v = float(metrics["elbo_psvo_direct"])
        assert np.isfinite(float(metrics["loss"]))
        first = v if first is None else first
        last = v
    assert last > first, (first, last)


@pytest.mark.fast
def test_logjoint_chunked_matches_direct(monkeypatch):
    """The long-T chunked selected-path log-joint (bounds the [*, B, M, ·]
    intermediates to one chunk) must be value- AND gradient-identical to
    the direct form, controls included."""
    import psvo_tpu.objectives as objectives_mod
    from psvo_tpu.config import Config, DataConfig, NetConfig, SMCConfig
    from psvo_tpu.models.ssm import init_ssm

    net = NetConfig(hidden=(8,))
    cfg = Config(
        name="lj", data=DataConfig(datatype="fhn", dx=2, dy=2, t_steps=9, di=1),
        smc=SMCConfig(objective="psvo", n_particles=16),
    ).with_nets(q0=net, q1=net, q2=net, f=net, g=net, qb=net)
    ssm, params = init_ssm(cfg, jax.random.key(0))
    T, B, M = 9, 3, 4
    x_c = jax.random.normal(jax.random.key(1), (T, B, M * 2))
    ys = jax.random.normal(jax.random.key(2), (T, B, 2))
    ctrl = jax.random.normal(jax.random.key(3), (T, B, 1))

    def run(chunk):
        monkeypatch.setattr(objectives_mod, "_LOGJOINT_CHUNK", chunk)

        def f(p, x):
            return jnp.sum(
                objectives_mod._selected_path_log_joint(ssm, p, x, ys, ctrl)
            )

        v = float(f(params, x_c))
        g = jax.grad(f, argnums=(0, 1))(params, x_c)
        return v, g

    vd, gd = run(10**9)  # direct
    vc, gc = run(4)  # 2 chunks of 4
    np.testing.assert_allclose(vd, vc, rtol=1e-6)
    for a, b in zip(jax.tree_util.tree_leaves(gd), jax.tree_util.tree_leaves(gc)):
        np.testing.assert_allclose(
            np.asarray(a), np.asarray(b), rtol=1e-5, atol=1e-6
        )


@pytest.mark.parametrize("m", [16, 64])
@pytest.mark.parametrize("datatype,kw", [("fhn", {}), ("lorenz63", {"obs_scale": 0.5})])
def test_svo_bound_matches_numpy_at_m(datatype, kw, m):
    """SVO's backward sweep at the preset's M=16 and the M=64 bench row."""
    cfg, ssm, params, ys = _setup(datatype, "svo", m=m, **kw)
    obj = jax.jit(
        lambda key: jnp.mean(make_objective(ssm, cfg)(params, key, ys).elbo)
    )
    jax_vals = np.array([float(obj(jax.random.key(600 + r))) for r in range(REPS)])
    model = NumpySSMParams.from_jax(params, ssm)
    np_vals = np.array(
        [
            float(np.mean(numpy_svo_elbo(model, np.asarray(ys), K, m, seed=700 + 3 * r)))
            for r in range(REPS)
        ]
    )
    _bands(jax_vals, np_vals)


@pytest.mark.parametrize("m", [16, 64])
@pytest.mark.parametrize("bound", ["forward", "direct"])
def test_ffbsi_bound_forms_match_numpy(bound, m):
    """FFBSi under both PSVO training bounds (the direct one keeps the sweep
    differentiable) reports the same three quantities as the NumPy FFBSi."""
    cfg, ssm, params, ys = _setup("fhn", "psvo", m=m, psvo_bound=bound)
    objective = make_objective(ssm, cfg)

    @jax.jit
    def run(key):
        out = objective(params, key, ys)
        return (
            jnp.mean(out.elbo),
            out.metrics["log_joint_smoothed"],
            out.metrics["elbo_psvo_direct"],
        )

    jax_vals = np.array(
        [[float(v) for v in run(jax.random.key(800 + r))] for r in range(REPS)]
    )
    model = NumpySSMParams.from_jax(params, ssm)
    np_vals = np.array(
        [
            [np.mean(v) for v in numpy_psvo_terms(model, np.asarray(ys), K, m, seed=900 + 3 * r)]
            for r in range(REPS)
        ]
    )
    for c in range(3):
        _bands(jax_vals[:, c], np_vals[:, c])
