"""Benchmark harness tests, without a device: the GPU-only guard, the row and
blob plumbing of `bench --all`, the params snapshot, the cross-device
comparison rule, and the trace reduction's interval arithmetic."""

from __future__ import annotations

import json
import os
import subprocess
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from psvo_tpu import benchmark

pytestmark = pytest.mark.fast

_REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def _cpu_env():
    env = dict(os.environ)
    env["JAX_PLATFORMS"] = "cpu"
    env.pop("XLA_FLAGS", None)
    return env


# --- the GPU-only guard ----------------------------------------------------


def test_bench_refuses_cpu_platform():
    """`python bench.py` on a CPU-only JAX exits non-zero with a JSON error
    line and measures nothing."""
    r = subprocess.run(
        [sys.executable, "bench.py", "--steps", "1"],
        cwd=_REPO, env=_cpu_env(), capture_output=True, text=True, timeout=300,
    )
    assert r.returncode != 0
    last = json.loads(r.stdout.strip().splitlines()[-1])
    assert last["platform"] == "cpu" and "no GPU" in last["error"]
    assert "value" not in last


@pytest.mark.parametrize("entry", ["main", "main_all", "main_to_target"])
def test_entry_points_require_gpu(entry, capsys):
    with pytest.raises(SystemExit) as ei:
        getattr(benchmark, entry)()
    assert ei.value.code == 1
    assert json.loads(capsys.readouterr().out)["platform"] == "cpu"


def test_device_description_names_platform_and_card(monkeypatch):
    monkeypatch.setattr(
        benchmark, "nvidia_smi_name_power", lambda: "NVIDIA H100 80GB HBM3, 700.00 W"
    )
    desc = benchmark.device_description()
    assert desc.startswith(f"cpu:{jax.devices()[0].device_kind} x")
    assert desc.endswith("| NVIDIA H100 80GB HBM3, 700.00 W")


def test_nvidia_smi_missing_is_reported(monkeypatch):
    monkeypatch.setenv("PATH", "")
    assert "unavailable" in benchmark.nvidia_smi_name_power()


def test_analytic_cost_uses_unpadded_state_dim():
    from psvo_tpu.config import preset

    cfg = preset("fhn_fivo_k1024_bench")
    _, gbytes = benchmark.analytic_cost(cfg)
    b, k, t, dx = 32, 1024, 100, 2
    assert gbytes == pytest.approx(3.0 * t * 4 * b * k * (3 * dx + 3) / 1e9)


def test_time_loop_waits_for_the_result():
    calls = []

    def fn():
        calls.append(1)
        return jnp.ones(3) * len(calls)

    assert benchmark.time_loop(fn, 4) > 0.0
    assert len(calls) == 4


# --- params snapshot roundtrip --------------------------------------------


def test_params_npz_roundtrip(tmp_path):
    params = {
        "f": {"w": jnp.arange(6.0).reshape(2, 3), "b": jnp.ones((3,))},
        "scales": (jnp.float32(2.0), jnp.zeros((4,))),
    }
    path = str(tmp_path / "snap.npz")
    benchmark.save_params_npz(params, path)
    template = jax.tree_util.tree_map(jnp.zeros_like, params)
    back = benchmark.load_params_npz(template, path)
    jax.tree_util.tree_map(
        lambda a, b: np.testing.assert_array_equal(np.asarray(a), np.asarray(b)),
        params,
        back,
    )


def test_params_npz_shape_mismatch_raises(tmp_path):
    params = {"w": jnp.ones((2, 3))}
    path = str(tmp_path / "snap.npz")
    benchmark.save_params_npz(params, path)
    with pytest.raises(ValueError, match="shape"):
        benchmark.load_params_npz({"w": jnp.ones((4, 3))}, path)


def test_l96_snapshot_fallback_names_reason(tmp_path, monkeypatch, capsys):
    """An unusable snapshot prints why, on a line naming the fallback."""
    import dataclasses

    from psvo_tpu.config import preset

    bad = str(tmp_path / "l96.npz")
    benchmark.save_params_npz({"w": jnp.ones((2, 3))}, bad)
    monkeypatch.setattr(benchmark, "_L96_CKPT", bad)
    cfg = preset("lorenz96_fivo_k8192_sharded")
    cfg = dataclasses.replace(
        cfg,
        data=dataclasses.replace(cfg.data, dx=4, dy=4, t_steps=4, n_train=4, n_test=2),
        train=dataclasses.replace(cfg.train, batch_size=2),
    )
    params = benchmark.l96_trained_params(cfg, pretrain_steps=1)
    err = capsys.readouterr().err
    line = next(l for l in err.splitlines() if "unusable" in l)
    assert "KeyError" in line and "fallback: pretraining 1 steps" in line
    assert params["f"]["mean"][0].shape[-1] == 4


# --- bench --all blob plumbing ---------------------------------------------


def _fake_row(cfg, value, regime, params):
    row = {
        "metric": f"train_steps_per_sec_{cfg.name}",
        "value": value,
        "unit": "steps/s",
        "timestamp": "t",
        "_final_params": None,
        "_ssm": None,
        "_batch": None,
    }
    if regime is not None:
        row["regime"] = regime
    if params is not None:
        row["used_params_override"] = True
    return row


@pytest.fixture
def _no_device(monkeypatch):
    monkeypatch.setattr(benchmark, "require_gpu", lambda: None)
    monkeypatch.setattr(benchmark, "device_description", lambda: "gpu:test")


def test_main_all_partial_blob_survives_crash(tmp_path, monkeypatch, _no_device):
    """If a row dies mid-run, the rows already measured are on disk with
    partial=true and provenance metadata."""
    calls = {"n": 0}

    def fake_measure(cfg, steps=30, adaptive=False, params=None, regime=None):
        calls["n"] += 1
        if calls["n"] >= 4:  # warmup + 2 rows succeed, 3rd row dies
            raise RuntimeError("row died")
        return _fake_row(cfg, 1.0, regime, params)

    monkeypatch.setattr(benchmark, "measure", fake_measure)
    monkeypatch.setattr(benchmark, "measure_to_target", lambda *a, **k: {"value": 1.0, "reached": True})
    monkeypatch.setattr(benchmark, "_numpy_baseline", lambda row, cfg: None)
    out = str(tmp_path / "BENCH_ALL.json")
    with pytest.raises(RuntimeError, match="died"):
        benchmark.main_all(steps=3, out_path=out)
    blob = json.load(open(out))
    assert blob["partial"] is True
    assert blob["device"] == "gpu:test"
    assert "git_sha" in blob and "timestamp" in blob
    # warmup isn't recorded; the two completed rows are
    assert list(blob["rows"]) == list(benchmark.ALL_ROWS[:2])


def test_main_all_complete_blob(tmp_path, monkeypatch, capsys, _no_device):
    """A full run flips partial=false, labels the K=8192 regimes, carries
    the trained-regime row, and prints the primary row without any
    equivalence bits."""

    def fake_measure(cfg, steps=30, adaptive=False, params=None, regime=None):
        assert cfg.mesh.data * cfg.mesh.particle == 1  # rows time one card
        return _fake_row(cfg, 2.0, regime, params)

    monkeypatch.setattr(benchmark, "measure", fake_measure)
    monkeypatch.setattr(benchmark, "measure_to_target", lambda *a, **k: {"value": 1.0, "reached": True})
    monkeypatch.setattr(benchmark, "_numpy_baseline", lambda row, cfg: 0.5)
    monkeypatch.setattr(benchmark, "l96_trained_params", lambda cfg: {"dummy": 1})
    out = str(tmp_path / "BENCH_ALL.json")
    rc = benchmark.main_all(steps=3, out_path=out)
    assert rc == 0
    blob = json.load(open(out))
    assert blob["partial"] is False
    rows = blob["rows"]
    assert rows["lorenz96_fivo_k8192_sharded"]["regime"] == "fresh-init"
    assert rows["lorenz96_fivo_k8192_trained"]["regime"] == "trained"
    assert rows["lorenz96_fivo_k8192_trained"]["used_params_override"] is True
    assert "fhn_fivo_k1024_b128" in rows
    assert rows["lorenz63_fivo_k8192"]["regime"] == "healthy-ess"
    assert rows["lorenz63_svo_k256_m64"]["regime"] == "m64"
    assert rows["lorenz63_psvo_k1024_t1025_seg8"]["regime"] == "long-T-segmented"
    assert blob["to_target"]["reached"] is True
    assert blob["vs_baseline"] == 4.0  # 2.0 steps/s vs 0.5 baseline
    primary = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    assert not any(k.endswith("_equiv_ok") for k in primary)


def test_main_all_to_target_failure_propagates(tmp_path, monkeypatch, _no_device):
    """A to-target run that raises fails the bench instead of being
    swallowed into the blob."""
    monkeypatch.setattr(
        benchmark, "measure",
        lambda cfg, steps=30, adaptive=False, params=None, regime=None:
            _fake_row(cfg, 1.0, regime, params),
    )
    monkeypatch.setattr(benchmark, "_numpy_baseline", lambda row, cfg: None)
    monkeypatch.setattr(benchmark, "l96_trained_params", lambda cfg: {})

    def boom(*a, **k):
        raise FloatingPointError("diverged")

    monkeypatch.setattr(benchmark, "measure_to_target", boom)
    with pytest.raises(FloatingPointError):
        benchmark.main_all(steps=3, out_path=str(tmp_path / "b.json"))


def test_main_all_unreached_target_exits_nonzero(tmp_path, monkeypatch, _no_device):
    monkeypatch.setattr(
        benchmark, "measure",
        lambda cfg, steps=30, adaptive=False, params=None, regime=None:
            _fake_row(cfg, 1.0, regime, params),
    )
    monkeypatch.setattr(benchmark, "_numpy_baseline", lambda row, cfg: None)
    monkeypatch.setattr(benchmark, "l96_trained_params", lambda cfg: {})
    monkeypatch.setattr(
        benchmark, "measure_to_target", lambda *a, **k: {"reached": False}
    )
    assert benchmark.main_all(steps=3, out_path=str(tmp_path / "b.json")) == 1


# --- the cross-device comparison rule ---------------------------------------


_G = {"a": np.array([1.0, -2.0, 0.5]), "b": np.array([[0.25, 3.0]])}


@pytest.mark.parametrize(
    "logz_u,scale,flip,ok",
    [
        (-100.0, 1.0, False, True),  # identical
        (-100.05, 1.004, False, True),  # inside every tolerance
        (-101.0, 1.0, False, False),  # log Ẑ off by 1e-2 relative
        (-100.0, 1.05, False, False),  # gradient norm off by 5%
        (-100.0, 1.0, True, False),  # same norm, other direction
    ],
)
def test_grads_agree_tolerances(logz_u, scale, flip, ok):
    gu = jax.tree_util.tree_map(lambda a: a * scale, _G)
    if flip:
        gu = {"a": _G["a"][::-1].copy(), "b": _G["b"]}
    got, detail = benchmark.grads_agree(-100.0, logz_u, _G, gu, "t")
    assert got is ok, detail


# --- trace reduction ---------------------------------------------------------


@pytest.mark.parametrize(
    "intervals,busy",
    [
        ([], 0),
        ([(0, 10)], 10),
        ([(0, 10), (5, 20)], 20),  # overlap
        ([(0, 10), (20, 30)], 20),  # gap
        ([(20, 30), (0, 10), (9, 21)], 30),  # unsorted, chained
    ],
)
def test_merged_busy_ns(intervals, busy):
    assert benchmark._merged_busy_ns(intervals) == busy


def _synthetic_train_steps(n_steps, iters, fwd, bwd, gap_ns=5):
    """Kernel events of n_steps train steps: a prologue kernel, a forward
    loop of `iters` bodies, a backward loop of `iters` bodies; each kernel
    lasts 10 ns and starts gap_ns after the previous one ends."""
    names = []
    for _ in range(n_steps):
        names += ["prologue"] + fwd * iters + bwd * iters
    return [(n, i * (10 + gap_ns), 10) for i, n in enumerate(names)]


# the second case shares a kernel between the loops, as the backward sweep's
# remat recompute can with the forward body
@pytest.mark.parametrize("fwd,bwd", [(["a", "b"], ["c", "d", "e"]), (["a", "s"], ["b", "s", "c"])])
def test_summarize_kernels_finds_the_timestep_loops(fwd, bwd):
    ev = _synthetic_train_steps(2, 3, fwd, bwd)
    out = benchmark.summarize_kernels(ev[::-1], n_steps=2, t_steps=4)  # any order
    assert out["kernels"] == len(ev) and out["kernels_per_step"] == len(ev) / 2
    assert out["kernels_per_timestep"] == len(fwd) + len(bwd)
    # loops in launch order; each loop's time is its bodies' span per step
    assert [lp["kernels_per_iteration"] for lp in out["timestep_loops"]] == [
        len(fwd), len(bwd)
    ]
    for lp in out["timestep_loops"]:
        n = 3 * lp["kernels_per_iteration"]
        assert lp["ms_per_step"] == pytest.approx((n * 15 - 5) / 1e6)
    assert out["window_ms"] == pytest.approx((len(ev) * 15 - 5) / 1e6)
    assert out["idle_share"] == pytest.approx(1 - 10 * len(ev) / (len(ev) * 15 - 5))


def test_summarize_kernels_requires_events():
    with pytest.raises(ValueError, match="no kernel events"):
        benchmark.summarize_kernels([], 1, 2)


def test_trace_summary_requires_a_gpu_plane(tmp_path):
    """A CPU trace has no /device:GPU:0 plane: the reduction says so
    instead of reporting an idle share of nothing."""
    f = jax.jit(lambda x: jnp.sin(x) @ x)
    x = jnp.ones((32, 32))
    f(x).block_until_ready()
    jax.profiler.start_trace(str(tmp_path))
    f(x).block_until_ready()
    jax.profiler.stop_trace()
    with pytest.raises(ValueError, match="GPU"):
        benchmark.trace_summary(str(tmp_path), 1, 2)
    with pytest.raises(FileNotFoundError):
        benchmark.trace_summary(str(tmp_path / "none"), 1, 2)
