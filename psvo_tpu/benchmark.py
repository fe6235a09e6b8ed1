"""Benchmark harness: the BASELINE.json primary metric, on one NVIDIA GPU.

Measures jitted train-step throughput (full SMC forward + backprop + Adam) on
the FHN K=1024 FIVO config, and compares against the "reference CPU"
stand-in — the trusted NumPy reimplementation of the reference's forward
objective (tests/reference_numpy/numpy_smc.py; the reference itself is
unrunnable, SURVEY.md §0). The comparison is conservative: the baseline
times only the forward pass while our number includes gradients and the
optimizer update.

Prints exactly ONE JSON line:
  {"metric": ..., "value": N, "unit": "steps/s", "vs_baseline": N,
   "device": ..., ...}

Every entry point refuses to measure anything but a GPU (`require_gpu`):
a timing of XLA's CPU backend is not a number about this system. Every row
names the card: JAX's device kind plus `nvidia-smi`'s name and power limit,
since a card set below its maximum power runs slower under load.
"""

from __future__ import annotations

import json
import os
import sys
import time

import jax
import jax.numpy as jnp
import numpy as np

from psvo_tpu.utils.rng import run_key

_REPO_ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
_L96_CKPT = os.path.join(_REPO_ROOT, "checkpoints", "l96_pretrained.npz")


def nvidia_smi_name_power() -> str:
    """`nvidia-smi --query-gpu=name,power.limit` for every card, '; '-joined
    (e.g. "NVIDIA H100 80GB HBM3, 700.00 W"), or why it is unavailable."""
    import subprocess

    try:
        r = subprocess.run(
            ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
            capture_output=True,
            text=True,
            timeout=30,
        )
    except (OSError, subprocess.TimeoutExpired) as e:
        return f"nvidia-smi unavailable ({e})"
    if r.returncode != 0:
        return f"nvidia-smi failed (rc={r.returncode})"
    return "; ".join(line.strip() for line in r.stdout.splitlines() if line.strip())


def device_description() -> str:
    """The measuring device as JAX sees it plus the card's name and power
    limit, e.g. "gpu:NVIDIA H100 80GB HBM3 x1 | NVIDIA H100 80GB HBM3, 700.00 W"."""
    devices = jax.devices()
    d = devices[0]
    return (
        f"{d.platform}:{d.device_kind} x{len(devices)} | {nvidia_smi_name_power()}"
    )


def require_gpu() -> None:
    """Exit non-zero with a one-line JSON error unless JAX's default device
    is a GPU. There is no CPU fallback: a CPU timing is not a device number."""
    platform = jax.devices()[0].platform
    if platform != "gpu":
        print(
            json.dumps(
                {
                    "error": f"no GPU: JAX's default platform is {platform!r}",
                    "platform": platform,
                }
            )
        )
        sys.exit(1)


def run_metadata() -> dict:
    """{git_sha, timestamp} provenance stamped into every blob."""
    import subprocess

    sha = "unknown"
    try:
        r = subprocess.run(
            ["git", "rev-parse", "--short", "HEAD"],
            cwd=_REPO_ROOT,
            capture_output=True,
            text=True,
            timeout=10,
        )
        sha = r.stdout.strip() or "unknown"
    except Exception:
        pass
    return {
        "git_sha": sha,
        "timestamp": time.strftime("%Y-%m-%dT%H:%M:%SZ", time.gmtime()),
    }


def time_loop(fn, n: int) -> float:
    """Seconds per call of n chained calls, ending in block_until_ready."""
    t0 = time.perf_counter()
    out = None
    for _ in range(n):
        out = fn()
    jax.block_until_ready(out)
    return (time.perf_counter() - t0) / n


def _time_windows(fn, n: int, windows: int = 3) -> list[float]:
    """`windows` independent chained windows of n calls each (the row
    reports their median and each window)."""
    return [time_loop(fn, n) for _ in range(windows)]


def _mlp_flops_per_row(din: int, hidden, dout: int) -> int:
    sizes = [din, *hidden, dout]
    return sum(2 * a * b for a, b in zip(sizes[:-1], sizes[1:]))


def analytic_cost(cfg) -> tuple[float, float]:
    """(GFLOP, GB) moved per train step — analytic lower bounds from the
    model structure, so the bench can report achieved FLOP/s and bytes/s
    next to steps/s (layout regressions show as a ratio, not just a
    throughput delta).

    FLOPs: per-timestep MLP matmuls over B·K rows (q1+f stacked, g; q2 runs
    per-trajectory) × T, × 4 for backward + remat recompute (bwd ≈ 2× fwd,
    remat re-runs the fwd). Bytes: the per-step particle-state HBM traffic —
    [B, Dx, K] carry read+write (+eps read, weights rw), × 3 for the
    backward sweep.
    """
    b, k, t = cfg.train.batch_size, cfg.smc.n_particles, cfg.data.t_steps
    dx, dy, di = cfg.data.dx, cfg.data.dy, cfg.data.di
    nets = {name: c for name, c in cfg.nets}
    per_row = (
        _mlp_flops_per_row(dx + di, nets["q1"].hidden, dx)
        + _mlp_flops_per_row(dx + di, nets["f"].hidden, dx)
        + _mlp_flops_per_row(dx, nets["g"].hidden, dy)
    )
    flops = 4.0 * t * b * k * per_row  # fwd + bwd(2x) + remat recompute
    bytes_per_ts = 4 * b * k * (2 * dx + dx + 3)  # x rw, eps r, logw/alpha rw
    gbytes = 3.0 * t * bytes_per_ts / 1e9
    return flops / 1e9, gbytes


def peak_bytes_in_use() -> int | None:
    """The default device's running peak of allocated bytes (process
    lifetime: it never decreases), or None where the backend keeps none."""
    stats = jax.devices()[0].memory_stats()
    return None if stats is None else stats.get("peak_bytes_in_use")


def measure(
    cfg, steps: int = 30, adaptive: bool = False, params=None, regime: str | None = None
) -> dict:
    """Measure one config's jitted train-step throughput.

    Returns the machine-readable row: median + per-window steps/s, step
    time, analytic FLOP/s and GB/s, the device's running peak memory,
    timestamp (+ regime label when given — e.g. the K=8192 rows differ only
    in their weight regime). With adaptive=True the window length is
    re-chosen from a short probe so every row gets ~2 s windows regardless
    of its per-step cost (K=8192 vs K=16 differ by ~100×). `params`
    overrides the fresh initialization (trained-regime rows).
    """
    from psvo_tpu.data import generate_dataset
    from psvo_tpu.models.ssm import init_ssm
    from psvo_tpu.train import make_optimizer, make_train_step

    dataset = generate_dataset(cfg.data, cfg.seed)
    ssm, init_params = init_ssm(cfg, run_key(cfg))
    if params is None:
        params = init_params
    optimizer = make_optimizer(cfg)
    opt_state = optimizer.init(params)
    train_step = make_train_step(ssm, cfg, optimizer)

    batch = jnp.asarray(dataset.obs_train[: cfg.train.batch_size])
    key = run_key(cfg, 1)

    # steps_per_call presets: one jitted call scans n_call steps; the bench
    # times CALLS and reports per-step numbers
    n_call = max(int(cfg.train.steps_per_call), 1)
    batch_flat = batch  # the numpy-baseline comparison wants [B, T, Dy]
    if n_call > 1:
        batch = jnp.stack([batch] * n_call)

    def _key(i):
        k = jax.random.fold_in(key, i)
        return jax.random.split(k, n_call) if n_call > 1 else k

    # Warmup: compile + a couple of steady-state steps.
    t_compile = time.perf_counter()
    p, s = params, opt_state
    for i in range(3):
        p, s, m = train_step(p, s, _key(i), batch)
    jax.block_until_ready(m["loss"])
    warmup_s = time.perf_counter() - t_compile

    state = {"p": p, "s": s, "i": 3, "m": m}

    def one_step():
        state["p"], state["s"], m = train_step(
            state["p"], state["s"], _key(state["i"]), batch
        )
        state["i"] += 1
        state["m"] = m
        return m["loss"]

    if adaptive:
        est = time_loop(one_step, 3)
        # sub-2 ms steps get 4 s windows: double the averaging where steps
        # are cheap (est times one CALL = n_call steps)
        target_s = 4.0 if est / n_call < 2e-3 else 2.0
        steps = max(5, int(target_s / max(est, 1e-4)) + 1)

    window_times = _time_windows(one_step, steps, windows=3)
    # median window; with chunked presets each timed call is n_call steps
    step_time = sorted(window_times)[len(window_times) // 2] / n_call
    gflop, gbyte = analytic_cost(cfg)
    row = {
        "metric": f"train_steps_per_sec_{cfg.name}",
        "value": 1.0 / step_time,
        "unit": "steps/s",
        "step_time_ms": step_time * 1e3,
        "window_steps": steps,
        "value_windows": [n_call / w for w in window_times],
        "warmup_s": warmup_s,
        "gflops_per_step": gflop,
        "achieved_gflops_per_sec": gflop / step_time,
        "gbytes_per_step": gbyte,
        "achieved_gbytes_per_sec": gbyte / step_time,
        "peak_bytes_in_use": peak_bytes_in_use(),
        "device": device_description(),
        "timestamp": time.strftime("%Y-%m-%dT%H:%M:%SZ", time.gmtime()),
    }
    if regime is not None:
        row["regime"] = regime
    row["loss"] = float(state["m"]["loss"])
    if "ess_mean" in state["m"]:
        row["ess_mean"] = float(state["m"]["ess_mean"])
    print(
        f"# device={row['device']} config={cfg.name} K={cfg.smc.n_particles} "
        f"T={cfg.data.t_steps} B={cfg.train.batch_size} "
        f"step_time={step_time*1e3:.3f}ms "
        f"windows={[f'{1e3*w:.2f}ms' for w in window_times]} "
        f"peak_bytes_in_use={row['peak_bytes_in_use']} "
        f"achieved={row['achieved_gflops_per_sec']:.2f} GFLOP/s "
        f"{row['achieved_gbytes_per_sec']:.2f} GB/s (analytic)",
        file=sys.stderr,
    )
    row["_final_params"] = state["p"]  # for the numpy-baseline comparison
    row["_ssm"] = ssm
    row["_batch"] = batch_flat
    return row


def _numpy_baseline(row, cfg) -> float | None:
    """Reference-CPU stand-in: NumPy forward objective, same model/batch."""
    try:  # the NumPy reference lives in the source checkout's tests/
        from tests.reference_numpy.numpy_smc import (
            NumpySSMParams,
            numpy_forward_filter,
        )
    except ModuleNotFoundError:
        return None
    model = NumpySSMParams.from_jax(row["_final_params"], row["_ssm"])
    ys_np = np.asarray(row["_batch"])
    t0 = time.perf_counter()
    reps = 2
    for r in range(reps):
        numpy_forward_filter(model, ys_np, cfg.smc.n_particles, seed=r)
    base_time = (time.perf_counter() - t0) / reps
    print(
        f"# numpy-cpu baseline: {base_time*1e3:.1f}ms/forward "
        f"({1.0/base_time:.2f} steps/s)",
        file=sys.stderr,
    )
    return 1.0 / base_time


def _strip(row: dict) -> dict:
    return {k: v for k, v in row.items() if not k.startswith("_")}


# ---------------------------------------------------------------------------
# Comparing two runs of one estimator on different devices
# ---------------------------------------------------------------------------


def grads_agree(
    lf, lu, gf, gu, label: str, *, logz_rtol: float = 1e-3,
    norm_rtol: float = 1e-2, min_cosine: float = 0.99,
) -> tuple[bool, str]:
    """Do (log Ẑ, gradient tree) pairs from two runs of the same estimator
    on the same noise agree?

    Per-leaf allclose is the wrong assertion here: a uniform draw that lands
    within f32 rounding of a CDF boundary flips one ancestor index when two
    devices sum the CDF in different orders, and that trajectory then
    diverges, moving a few gradient entries by a large relative amount. The
    meaningful invariants are log Ẑ, the gradient norm and the gradient
    DIRECTION (cosine): a real bug wrecks all three, an index flip none."""
    lf, lu = float(lf), float(lu)
    fa = np.concatenate(
        [np.asarray(x, np.float64).ravel() for x in jax.tree_util.tree_leaves(gf)]
    )
    ua = np.concatenate(
        [np.asarray(x, np.float64).ravel() for x in jax.tree_util.tree_leaves(gu)]
    )
    nf, nu = float(np.linalg.norm(fa)), float(np.linalg.norm(ua))
    cos = float(fa @ ua / max(nf * nu, 1e-30))
    logz_rel = abs(lf - lu) / max(abs(lu), 1e-30)
    norm_rel = abs(nf - nu) / max(nf, nu, 1e-30)
    ok = logz_rel <= logz_rtol and norm_rel <= norm_rtol and cos >= min_cosine
    detail = (
        f"logZ {lf:.6f} vs {lu:.6f} (rel {logz_rel:.2e} <= {logz_rtol:g}) "
        f"grad_norm {nf:.6f} vs {nu:.6f} (rel {norm_rel:.2e} <= {norm_rtol:g}) "
        f"cosine {cos:.6f} (>= {min_cosine:g})"
    )
    print(f"# {label} {'OK' if ok else 'MISMATCH'}: {detail}", file=sys.stderr)
    return ok, detail


# ---------------------------------------------------------------------------
# Trained-regime params for the K=8192 row
# ---------------------------------------------------------------------------


def save_params_npz(params, path: str) -> None:
    """Flat .npz snapshot of a params pytree (keyed by tree path)."""
    from jax.tree_util import keystr, tree_flatten_with_path

    leaves, _ = tree_flatten_with_path(params)
    os.makedirs(os.path.dirname(path), exist_ok=True)
    np.savez(path, **{keystr(kp): np.asarray(v) for kp, v in leaves})


def load_params_npz(params_template, path: str):
    """Rebuild a params pytree from a flat .npz against a same-structure
    template (shapes must match — it's a snapshot, not a checkpoint)."""
    from jax.tree_util import keystr, tree_flatten_with_path, tree_unflatten

    data = np.load(path)
    leaves, treedef = tree_flatten_with_path(params_template)
    new = []
    for kp, leaf in leaves:
        arr = data[keystr(kp)]
        if arr.shape != np.shape(leaf):
            raise ValueError(
                f"{path}: leaf {keystr(kp)} has shape {arr.shape}, "
                f"template wants {np.shape(leaf)}"
            )
        new.append(jnp.asarray(arr))
    return tree_unflatten(treedef, new)


def l96_trained_params(cfg, pretrain_steps: int = 300):
    """Params for the trained-regime K=8192 row.

    Fresh-init weights put the L96 filter at mean ESS ≈ 1.3; the trained
    row measures the weight regime real training runs in after warm-up.
    Loads the committed snapshot (checkpoints/l96_pretrained.npz) when
    present; else pretrains briefly at K=512 (params are K-independent —
    only net shapes matter) and saves the snapshot for later runs.
    """
    import dataclasses

    from psvo_tpu.models.ssm import init_ssm
    from psvo_tpu.train import make_optimizer, make_train_step
    from psvo_tpu.data import generate_dataset

    _, template = init_ssm(cfg, run_key(cfg))
    if os.path.exists(_L96_CKPT):
        try:
            return load_params_npz(template, _L96_CKPT)
        except (KeyError, ValueError) as e:  # net shapes changed since saving
            print(
                f"# l96 snapshot {_L96_CKPT} unusable ({type(e).__name__}: {e}); "
                f"fallback: pretraining {pretrain_steps} steps at K=512",
                file=sys.stderr,
            )

    pre = dataclasses.replace(
        cfg,
        name="l96_pretrain",
        smc=dataclasses.replace(cfg.smc, n_particles=512),
        mesh=dataclasses.replace(cfg.mesh, data=1, particle=1),
        train=dataclasses.replace(cfg.train, steps_per_call=1),
    )
    dataset = generate_dataset(pre.data, pre.seed)
    ssm, params = init_ssm(pre, run_key(pre))
    optimizer = make_optimizer(pre)
    opt_state = optimizer.init(params)
    step = make_train_step(ssm, pre, optimizer)
    batch = jnp.asarray(dataset.obs_train[: pre.train.batch_size])
    key = run_key(pre, 1)
    t0 = time.perf_counter()
    for i in range(pretrain_steps):
        params, opt_state, m = step(params, opt_state, jax.random.fold_in(key, i), batch)
    print(
        f"# l96 pretrain: {pretrain_steps} steps K=512 in "
        f"{time.perf_counter()-t0:.1f}s (loss {float(m['loss']):.1f})",
        file=sys.stderr,
    )
    try:
        save_params_npz(params, _L96_CKPT)
        print(f"# wrote {_L96_CKPT}", file=sys.stderr)
    except OSError as e:
        print(f"# could not save l96 snapshot: {e}", file=sys.stderr)
    return params


# ---------------------------------------------------------------------------
# Entry points
# ---------------------------------------------------------------------------


def main(preset_name: str = "fhn_fivo_k1024_bench", steps: int = 30) -> int:
    from psvo_tpu.config import preset

    require_gpu()
    cfg = preset(preset_name)
    row = measure(cfg, steps)
    base_sps = _numpy_baseline(row, cfg)
    out = _strip(row)
    out["vs_baseline"] = row["value"] / base_sps if base_sps else None
    out.update(run_metadata())
    print(json.dumps(out))
    return 0


# The BASELINE.json benchmark table: the five reference configs + primary.
ALL_ROWS = (
    "fhn_iwae_k16",
    "fhn_fivo_k128",
    "lorenz63_svo_k256",
    "lorenz63_psvo_k1024",
    "lorenz96_fivo_k8192_sharded",
    "fhn_fivo_k1024_bench",
)


def single_device(cfg):
    """`cfg` with its mesh set to 1×1: the bench rows time one card."""
    import dataclasses

    return dataclasses.replace(
        cfg, mesh=dataclasses.replace(cfg.mesh, data=1, particle=1)
    )


def long_t_config():
    """The long-T row: L63 PSVO at T=1025 with an 8-segment FFBSi cache."""
    import dataclasses

    from psvo_tpu.config import preset

    base = preset("lorenz63_psvo_k1024")
    return dataclasses.replace(
        base,
        name="lorenz63_psvo_k1024_t1025_seg8",
        data=dataclasses.replace(base.data, t_steps=1025, n_train=16, n_test=8),
        smc=dataclasses.replace(base.smc, ffbsi_segments=8),
        train=dataclasses.replace(base.train, batch_size=8, steps_per_call=1),
    )


def main_all(steps: int = 30, out_path: str = "BENCH_ALL.json") -> int:
    """Measure every BASELINE row in one invocation: one machine-readable
    blob, rewritten after every row with partial=true so a mid-run kill
    leaves the rows already measured on disk. Runs a throwaway warmup
    config first (the first config in a fresh process carries one-off
    start-up costs)."""
    import dataclasses

    from psvo_tpu.config import preset

    require_gpu()
    meta = run_metadata()
    blob: dict = {
        "partial": True, "rows": {}, "device": device_description(), **meta
    }

    def _flush():
        with open(out_path, "w") as f:
            json.dump(blob, f, indent=1)

    def _row(cfg, **kw):
        blob["rows"][cfg.name] = row = _strip(measure(cfg, steps, adaptive=True, **kw))
        print(f"#row {json.dumps(row)}", file=sys.stderr)
        _flush()

    warm = dataclasses.replace(
        preset("fhn_fivo_k128"),
        data=dataclasses.replace(preset("fhn_fivo_k128").data, n_train=32, n_test=8),
    )
    print("# warmup (discarded)", file=sys.stderr)
    measure(warm, steps=3)

    primary_vs = None
    for name in ALL_ROWS:
        cfg = single_device(preset(name))
        regime = "fresh-init" if name == "lorenz96_fivo_k8192_sharded" else None
        row = measure(cfg, steps, adaptive=True, regime=regime)
        if name == "fhn_fivo_k1024_bench":
            base = _numpy_baseline(row, cfg)
            primary_vs = row["value"] / base if base else None
        blob["rows"][name] = _strip(row)
        print(f"#row {json.dumps(blob['rows'][name])}", file=sys.stderr)
        _flush()

    # trained-regime K=8192 row: the weight regime real training runs in
    cfg5 = single_device(preset("lorenz96_fivo_k8192_sharded"))
    cfg5t = dataclasses.replace(cfg5, name="lorenz96_fivo_k8192_trained")
    _row(cfg5t, params=l96_trained_params(cfg5), regime="trained")

    # large K in a healthy-ESS regime: at D=40 the ESS stays O(1) however
    # trained the weights are, so this dx=3 row is where K=8192 resampling
    # moves a spread of ancestors
    l63 = preset("lorenz63_psvo_k1024")
    _row(
        dataclasses.replace(
            l63,
            name="lorenz63_fivo_k8192",
            smc=dataclasses.replace(l63.smc, objective="fivo", n_particles=8192),
            train=dataclasses.replace(l63.train, batch_size=8, steps_per_call=1),
            data=dataclasses.replace(l63.data, n_train=16, n_test=8),
        ),
        regime="healthy-ess",
    )

    # long-T row: L63 PSVO at T=1025 with the segmented FFBSi cache (the
    # long-sequence path: O(T/S) persistent forward state, recomputed
    # segment by segment in the backward sweep)
    _row(long_t_config(), regime="long-T-segmented")

    # SVO at M=64: the backward sweep's cost grows with M
    svo = preset("lorenz63_svo_k256")
    _row(
        dataclasses.replace(
            svo,
            name="lorenz63_svo_k256_m64",
            smc=dataclasses.replace(svo.smc, n_smoothing_particles=64),
        ),
        regime="m64",
    )

    # the B=128 batch-scaling row
    b128 = preset("fhn_fivo_k1024_bench")
    _row(
        dataclasses.replace(
            b128,
            name="fhn_fivo_k1024_b128",
            train=dataclasses.replace(b128.train, batch_size=128),
            data=dataclasses.replace(b128.data, n_train=256),
        )
    )

    # wall-clock-to-target-ELBO; a failed training run fails the bench
    blob["to_target"] = measure_to_target()
    _flush()

    blob["primary"] = "fhn_fivo_k1024_bench"
    blob["vs_baseline"] = primary_vs
    blob["partial"] = False
    _flush()
    print(f"# wrote {out_path}", file=sys.stderr)
    primary = dict(blob["rows"]["fhn_fivo_k1024_bench"])
    primary["vs_baseline"] = primary_vs
    primary.update(meta)
    print(json.dumps(primary))
    return 0 if blob["to_target"]["reached"] else 1


# ---------------------------------------------------------------------------
# One profiler trace of a steady window: kernels per step and idle share
# ---------------------------------------------------------------------------


def _merged_busy_ns(intervals: list[tuple[int, int]]) -> int:
    """Length of the union of [start, end) intervals."""
    busy, cur_s, cur_e = 0, None, None
    for st, en in sorted(intervals):
        if cur_e is None or st > cur_e:
            if cur_e is not None:
                busy += cur_e - cur_s
            cur_s, cur_e = st, en
        else:
            cur_e = max(cur_e, en)
    if cur_e is not None:
        busy += cur_e - cur_s
    return busy


def summarize_kernels(events, n_steps: int, t_steps: int) -> dict:
    """Device metrics from kernel events (name, start_ns, duration_ns) of
    n_steps train steps of a T-step model.

    The window is the span from the first kernel's start to the last
    kernel's end; busy is the union of kernel intervals in it and idle share
    is 1 − busy/window. The timestep loops are found by their period: a
    kernel launched exactly once per iteration of a T−1-step scan occurs
    n_steps·(T−1) times, and the distance between its successive launches
    is that loop body's kernel count. In a train step the forward filter
    comes first and the backward sweep (which re-runs the forward body under
    remat) after it, so the loops are listed in launch order. Op names
    cannot tell them apart: XLA launches the kernels of a loop body from one
    command buffer."""
    import statistics

    if not events:
        raise ValueError("no kernel events")
    events = sorted(events, key=lambda e: e[1])
    t0 = events[0][1]
    t1 = max(s + d for _, s, d in events)
    busy = _merged_busy_ns([(s, s + d) for _, s, d in events])

    where: dict[str, list[int]] = {}
    time_ns: dict[str, int] = {}
    for i, (name, _, dur) in enumerate(events):
        where.setdefault(name, []).append(i)
        time_ns[name] = time_ns.get(name, 0) + dur
    iters = max(t_steps - 1, 1)
    per_ts = n_steps * iters
    loops: dict[int, tuple[int, str]] = {}  # body length -> (first launch, marker)
    for name, idx in where.items():
        if len(idx) == per_ts:
            body = int(statistics.median(b - a for a, b in zip(idx, idx[1:])))
            loops[body] = min(loops.get(body, (idx[0], name)), (idx[0], name))

    def loop_ms(body: int, marker: str) -> float:
        """Mean device time per train step of the loop `marker` belongs to:
        from its first launch in a step to the end of that step's last body."""
        idx = where[marker]
        total = 0
        for s in range(n_steps):
            first, last = idx[s * iters], min(idx[(s + 1) * iters - 1] + body, len(events))
            total += max(st + d for _, st, d in events[first:last]) - events[first][1]
        return total / n_steps / 1e6

    top = sorted(time_ns, key=lambda n: -time_ns[n])[:15]
    return {
        "n_steps": n_steps,
        "kernels": len(events),
        "kernels_per_step": len(events) / n_steps,
        "kernels_per_timestep": sum(
            len(i) / per_ts for i in where.values() if len(i) >= per_ts
        ),
        "timestep_loops": [
            {"kernels_per_iteration": body, "ms_per_step": loop_ms(body, marker)}
            for body, (_, marker) in sorted(loops.items(), key=lambda kv: kv[1])
        ],
        "window_ms": (t1 - t0) / 1e6,
        "busy_ms": busy / 1e6,
        "idle_share": 1.0 - busy / max(t1 - t0, 1),
        "top_kernels": [
            {"name": n, "count": len(where[n]), "total_ms": time_ns[n] / 1e6}
            for n in top
        ],
    }


def trace_summary(trace_dir: str, n_steps: int, t_steps: int) -> dict:
    """`summarize_kernels` of the newest `.xplane.pb` under trace_dir: the
    device kernels are the events on the `/device:GPU:0` plane's stream
    lines."""
    import glob

    from jax.profiler import ProfileData

    paths = sorted(
        glob.glob(os.path.join(trace_dir, "**", "*.xplane.pb"), recursive=True),
        key=os.path.getmtime,
    )
    if not paths:
        raise FileNotFoundError(f"no .xplane.pb under {trace_dir}")
    data = ProfileData.from_file(paths[-1])
    planes = [p for p in data.planes if p.name.startswith("/device:GPU:0")]
    if not planes:
        raise ValueError(
            f"no /device:GPU:0 plane in {paths[-1]}: "
            f"{[p.name for p in data.planes]}"
        )
    events = [
        (ev.name, int(ev.start_ns), int(ev.duration_ns))
        for line in planes[0].lines
        if line.name.startswith("Stream")
        for ev in line.events
    ]
    return {
        "trace": paths[-1],
        **summarize_kernels(events, n_steps, t_steps),
        "device": device_description(),
    }


def main_trace(preset_name: str, trace_dir: str, calls: int = 1) -> int:
    """Trace `calls` steady-state train-step calls of one preset (after
    two compile-and-warmup calls) and print the trace_summary as the JSON
    line."""
    from psvo_tpu.config import preset
    from psvo_tpu.data import generate_dataset
    from psvo_tpu.models.ssm import init_ssm
    from psvo_tpu.train import make_optimizer, make_train_step

    require_gpu()
    cfg = single_device(preset(preset_name))
    dataset = generate_dataset(cfg.data, cfg.seed)
    ssm, params = init_ssm(cfg, run_key(cfg))
    optimizer = make_optimizer(cfg)
    opt_state = optimizer.init(params)
    step = make_train_step(ssm, cfg, optimizer)
    n_call = max(int(cfg.train.steps_per_call), 1)
    batch = jnp.asarray(dataset.obs_train[: cfg.train.batch_size])
    if n_call > 1:
        batch = jnp.stack([batch] * n_call)
    key = run_key(cfg, 1)

    def _key(i):
        k = jax.random.fold_in(key, i)
        return jax.random.split(k, n_call) if n_call > 1 else k

    for i in range(2):
        params, opt_state, m = step(params, opt_state, _key(i), batch)
    jax.block_until_ready(m["loss"])
    jax.profiler.start_trace(trace_dir)
    for i in range(calls):
        params, opt_state, m = step(params, opt_state, _key(2 + i), batch)
    jax.block_until_ready(m["loss"])
    jax.profiler.stop_trace()
    out = trace_summary(trace_dir, calls * n_call, cfg.data.t_steps)
    out["metric"] = f"trace_{cfg.name}"
    print(json.dumps(out))
    return 0


def measure_to_target(
    preset_name: str = "fhn_fivo_k1024_bench",
    target_elbo: float = -15.0,
    max_steps: int = 3000,
    eval_every: int = 50,
) -> dict:
    """The second half of the BASELINE.json metric — wall-clock (and steps)
    to reach a fixed held-out ELBO on the primary config, from scratch at a
    fixed seed.

    Times THE CANONICAL Trainer loop, driven in eval_every-sized chunks
    with a target-stop between chunks: a hand-rolled loop would walk its
    own key chain and batches, and so time a different training run.
    Reports total seconds (incl. compile) and steady seconds (excluding the
    first chunk, which carries compile; the persistent cache amortizes it
    across runs)."""
    import dataclasses

    from psvo_tpu.config import preset
    from psvo_tpu.data import generate_dataset
    from psvo_tpu.models.ssm import init_ssm
    from psvo_tpu.train import Trainer

    cfg = preset(preset_name)
    spc = max(int(cfg.train.steps_per_call), 1)
    if eval_every % spc:
        eval_every = -(-eval_every // spc) * spc
    cfg = dataclasses.replace(
        cfg,
        train=dataclasses.replace(
            cfg.train,
            eval_every=eval_every,
            save_every=max_steps,
            n_steps=max_steps,
            patience=10**6,  # the target-stop below is the only stop
            # chunked driving would otherwise snap params back to the best
            # snapshot at every chunk boundary (Trainer.run's keep_best
            # epilogue) — a different trajectory than one long run
            keep_best=False,
        ),
    )

    dataset = generate_dataset(cfg.data, cfg.seed)
    ssm, params = init_ssm(cfg, run_key(cfg))
    trainer = Trainer(cfg, ssm, params)

    t0 = time.perf_counter()
    t_first = None
    reached = None
    while trainer.state.step < max_steps:
        trainer.run(
            dataset.obs_train,
            dataset.obs_test,
            n_steps=min(trainer.state.step + eval_every, max_steps),
        )
        if t_first is None:
            t_first = time.perf_counter()
        elbo = trainer.history[-1]["test_elbo"]
        if elbo >= target_elbo:
            reached = elbo
            break

    t_end = time.perf_counter()
    return {
        "metric": f"seconds_to_test_elbo_{target_elbo:g}_{cfg.name}",
        "value": t_end - t0,
        "unit": "s",
        "seconds_steady": t_end - (t_first or t0),
        "steps": trainer.state.step,
        "test_elbo": reached,
        "reached": reached is not None,
        "eval_every": eval_every,
        "device": device_description(),
        **run_metadata(),
    }


def main_to_target(
    preset_name: str = "fhn_fivo_k1024_bench", target_elbo: float = -15.0
) -> int:
    require_gpu()
    out = measure_to_target(preset_name, target_elbo)
    print(json.dumps(out))
    return 0 if out["reached"] else 1
