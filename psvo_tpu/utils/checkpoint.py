"""NumPy `.npz` checkpointing: step-exact resume including PRNG key state.

The reference has no mid-run resume (SURVEY.md §5 "Checkpoint / resume:
essentially absent"); the rebuild saves (params, optimizer state, best
params, PRNG key data, step, early-stopping state, config hash) every N
steps into one `.npz` file per step, with a `--resume` CLI flag. Each file is
written to a temporary name and renamed into place, so a run killed
mid-save leaves the previous checkpoints intact. Restart is deterministic:
the PRNG key is serialized via its raw key data.

Pytrees are stored as their flattened leaves in tree order
(`params/0`, `params/1`, ...); restoring unflattens them into the caller's
template, so the template fixes the structure and every leaf's shape is
checked against it.
"""

from __future__ import annotations

import os
import re
from pathlib import Path
from typing import Optional

import jax
import jax.numpy as jnp
import numpy as np

_NAME = re.compile(r"^ckpt_(\d+)\.npz$")


def _flat(prefix: str, tree) -> dict[str, np.ndarray]:
    leaves = jax.tree_util.tree_leaves(tree)
    return {f"{prefix}/{i}": np.asarray(leaf) for i, leaf in enumerate(leaves)}


def _unflat(prefix: str, template, data) -> object:
    leaves, treedef = jax.tree_util.tree_flatten(template)
    n_saved = sum(1 for name in data.files if name.startswith(prefix + "/"))
    if n_saved != len(leaves):
        raise ValueError(
            f"checkpoint holds {n_saved} {prefix} leaves, template has {len(leaves)}"
        )
    out = []
    for i, leaf in enumerate(leaves):
        arr = data[f"{prefix}/{i}"]
        if arr.shape != np.shape(leaf):
            raise ValueError(
                f"checkpoint {prefix} leaf {i} has shape {arr.shape}, "
                f"template wants {np.shape(leaf)}"
            )
        out.append(jnp.asarray(arr))
    return jax.tree_util.tree_unflatten(treedef, out)


class Checkpointer:
    def __init__(self, directory: str | Path, config_hash: str, max_to_keep: int = 3):
        self.directory = Path(directory).absolute()
        self.config_hash = config_hash
        self.max_to_keep = max_to_keep
        self._last_saved = -1

    def steps(self) -> list[int]:
        """Saved steps, oldest first."""
        if not self.directory.is_dir():
            return []
        found = (_NAME.match(p.name) for p in self.directory.iterdir())
        return sorted(int(m.group(1)) for m in found if m)

    def _path(self, step: int) -> Path:
        return self.directory / f"ckpt_{step:010d}.npz"

    def save(self, state, force: bool = False) -> None:
        if state.step == self._last_saved and not force:
            return
        # best_params must travel with best_elbo: restoring the threshold
        # without the matching snapshot would end a resumed keep_best run on
        # the last (possibly diverged) params.
        has_best = state.best_params is not None
        payload = {
            **_flat("params", state.params),
            **_flat("opt_state", state.opt_state),
            **(_flat("best_params", state.best_params) if has_best else {}),
            "key_data": np.asarray(jax.random.key_data(state.key)),
            "step": np.int64(state.step),
            "best_elbo": np.float64(state.best_elbo),
            "evals_since_best": np.int64(state.evals_since_best),
            "has_best": np.bool_(has_best),
            "config_hash": np.str_(self.config_hash),
        }
        self.directory.mkdir(parents=True, exist_ok=True)
        final = self._path(state.step)
        tmp = final.with_name(final.name + ".tmp")
        with open(tmp, "wb") as f:
            np.savez(f, **payload)
            f.flush()
            os.fsync(f.fileno())
        os.replace(tmp, final)
        self._last_saved = state.step
        for old in self.steps()[: -self.max_to_keep]:
            self._path(old).unlink()

    def _latest(self):
        steps = self.steps()
        return np.load(self._path(steps[-1])) if steps else None

    def restore_params(self, params_template):
        """Restore ONLY the model params (evaluation/inspection path).

        Decoupled from the optimizer-state tree on purpose: optimizer
        structure may evolve across versions without invalidating saved
        models.
        """
        data = self._latest()
        if data is None:
            return None
        with data:
            return _unflat("params", params_template, data)

    def restore(self, state, strict: bool = True) -> Optional[object]:
        """Restore into a template TrainState; returns None if no checkpoint.

        strict=False skips the config-hash check (tooling/inspection only)."""
        data = self._latest()
        if data is None:
            return None
        with data:
            saved_hash = str(data["config_hash"])
            if strict and saved_hash != self.config_hash:
                raise ValueError(
                    f"checkpoint config hash {saved_hash!r} != current {self.config_hash!r}"
                )
            state.params = _unflat("params", state.params, data)
            state.opt_state = _unflat("opt_state", state.opt_state, data)
            state.best_params = (
                _unflat("best_params", state.params, data)
                if bool(data["has_best"])
                else None
            )
            state.key = jax.random.wrap_key_data(
                jnp.asarray(data["key_data"]), impl=jax.random.key_impl(state.key)
            )
            state.step = int(data["step"])
            state.best_elbo = float(data["best_elbo"])
            state.evals_since_best = int(data["evals_since_best"])
        self._last_saved = state.step
        return state
