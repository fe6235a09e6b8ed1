"""`chip_smoke.py` on the CPU: it refuses to run without a GPU, and each of
its phases runs and checks correctly at tiny shapes (the card runs the same
functions at the presets' widths)."""

from __future__ import annotations

import dataclasses
import json
import os
import shutil
import subprocess
import sys

import jax
import pytest

import chip_smoke

_REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def _tiny(cfg):
    """Shrink K/T/B, keep every other setting of the preset."""
    t = 17 if cfg.smc.ffbsi_segments > 1 else 6  # T−1 divisible by 8 segments
    return dataclasses.replace(
        cfg,
        data=dataclasses.replace(
            cfg.data, t_steps=t, n_train=8 * cfg.mesh.data, n_test=4,
            dx=min(cfg.data.dx, 6), dy=min(cfg.data.dy, 6),
        ),
        smc=dataclasses.replace(
            cfg.smc, n_particles=16, n_smoothing_particles=4
        ),
        train=dataclasses.replace(
            cfg.train, batch_size=4 * cfg.mesh.data, steps_per_call=1
        ),
    )


def _run(args, cwd, tmp_path):
    env = dict(os.environ)
    env["JAX_PLATFORMS"] = "cpu"
    env["JAX_COMPILATION_CACHE_DIR"] = str(tmp_path / "cache")
    return subprocess.run(
        [sys.executable, "chip_smoke.py", *args],
        cwd=cwd, env=env, capture_output=True, text=True, timeout=300,
    )


@pytest.mark.parametrize("args", [[], ["--multi"]])
def test_refuses_cpu_platform(args, tmp_path):
    r = _run(args, _REPO, tmp_path)
    assert r.returncode == 1
    assert r.stdout.strip() == ""  # no result line
    assert "no GPU" in r.stderr


def test_fails_without_the_repo(tmp_path):
    """Alone in a directory the script cannot import the system: it exits
    non-zero and prints no result, whatever the platform."""
    shutil.copy(os.path.join(_REPO, "chip_smoke.py"), tmp_path)
    r = _run([], tmp_path, tmp_path)
    assert r.returncode != 0
    assert '"ok"' not in r.stdout


def test_final_line_shape():
    line = chip_smoke.final_line(jax.devices()[:4])
    d = jax.devices()[0]
    assert json.loads(line) == {
        "ok": True,
        "device": {"platform": d.platform, "kind": d.device_kind, "count": 4},
    }


def test_one_card_configs_cover_every_baseline_row():
    from psvo_tpu.benchmark import ALL_ROWS

    cfgs = chip_smoke.one_card_configs()
    names = [c.name for c in cfgs]
    assert set(ALL_ROWS) <= set(names)
    assert chip_smoke.LONG_T in names and len(names) == len(ALL_ROWS) + 1
    assert all(c.mesh.data * c.mesh.particle == 1 for c in cfgs)
    # full widths: nothing shrunk on the card
    by = {c.name: c for c in cfgs}
    assert by["fhn_fivo_k1024_bench"].smc.n_particles == 1024
    assert by["fhn_fivo_k1024_bench"].train.batch_size == 32
    assert by["lorenz96_fivo_k8192_sharded"].smc.n_particles == 8192


def test_phase_objectives_tiny(capsys):
    cfgs = chip_smoke.one_card_configs(_tiny)
    long_t = [c for c in cfgs if c.name == chip_smoke.LONG_T]
    rows = chip_smoke.phase_objectives(cfgs[:2] + long_t, steps=1)
    assert len(rows) == 3
    out = capsys.readouterr().out
    assert out.count("[objectives]") == 3 and "step_time_ms=" in out


def test_phase_train_resume_tiny(tmp_path, capsys):
    run_dir = chip_smoke.phase_train(
        tmp_path, steps=3, more=2,
        sets=("smc.n_particles=16", "data.t_steps=6", "data.n_train=8",
              "data.n_test=4", "train.batch_size=4"),
    )
    out = capsys.readouterr().out
    assert "max rel loss diff 0.0" in out  # bit-exact on the CPU
    chip_smoke.phase_inference(run_dir, n_streams=2)
    assert capsys.readouterr().out.count("[inference]") == 2


@pytest.mark.parametrize("preset", ["fhn_fivo_k1024_bench", "lorenz63_psvo_k1024"])
def test_phase_gpu_vs_cpu_tiny(preset):
    from psvo_tpu.config import preset as get

    cfg = _tiny(get(preset))
    detail = chip_smoke.phase_gpu_vs_cpu(cfg, jax.devices()[:2])
    assert "cosine 1.000000" in detail


def test_phase_precision_tiny():
    from psvo_tpu.config import preset

    lz_def, lz_hi = chip_smoke.phase_precision(
        _tiny(preset("fhn_fivo_k1024_bench")), jax.devices()[0]
    )
    assert lz_def == pytest.approx(lz_hi, rel=1e-3)


def test_phase_oracles_small():
    chip_smoke.phase_oracles(k=2048, seeds=4, batch=2, t_steps=10, m=64, smooth_seeds=3)


@pytest.mark.parametrize("i,name", [(0, "lorenz96"), (1, "psvo"), (2, "b128")])
def test_phase_multi_on_four_virtual_devices(i, name):
    """The --multi phases on 4 virtual CPU devices: each sharded path must
    agree with the one-device run."""
    cfg = chip_smoke.multi_configs(_tiny)[i]
    assert cfg.mesh.data * cfg.mesh.particle == 4
    detail = chip_smoke.phase_multi(cfg, jax.devices()[:4], n_time=1)
    assert "MISMATCH" not in detail
