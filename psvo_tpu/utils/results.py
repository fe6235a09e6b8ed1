"""Results directory management: hyperparam JSON, metric logs, plots.

Covers the reference's `rslts_saving/rslts_saving.py` + `datetools.py`
(SURVEY.md §2-A, unverified paths): create a timestamped results dir, dump the
full config as JSON, store metric histories, and emit the experiment plots
(ELBO curves, FHN phase portraits, Lorenz 3-D trajectories) via
`psvo_tpu.utils.plots`.
"""

from __future__ import annotations

import json
from datetime import datetime
from pathlib import Path

from psvo_tpu.config import Config


class ResultsDir:
    def __init__(self, root: str | Path, cfg: Config):
        stamp = datetime.now().strftime("%Y%m%d_%H%M%S")
        self.path = Path(root) / f"{cfg.name}_{stamp}"
        self.path.mkdir(parents=True, exist_ok=True)
        self.cfg = cfg
        self.save_params_json()

    def save_params_json(self) -> None:
        """The reference's save_experiment_param: full hyperparams as JSON."""
        payload = self.cfg.to_dict()
        payload["config_hash"] = self.cfg.config_hash()
        (self.path / "params.json").write_text(json.dumps(payload, indent=2, default=str))

    def metrics_path(self) -> Path:
        return self.path / "metrics.jsonl"

    def checkpoint_dir(self) -> Path:
        return self.path / "checkpoints"

    def save_history(self, history: list[dict]) -> None:
        (self.path / "history.json").write_text(json.dumps(history, indent=2))

    def plot_all(self, history, dataset=None, inferred=None) -> list[Path]:
        """Write the experiment plots. Raises ModuleNotFoundError when
        matplotlib is not installed (plots are optional: `pip install
        .[plots]`)."""
        from psvo_tpu.utils import plots

        written = []
        if history:
            written.append(plots.plot_elbo_curve(history, self.path / "elbo.png"))
            written.append(plots.plot_r2(history, self.path / "r2.png"))
        if dataset is not None and inferred is not None:
            dx = dataset.hidden_test.shape[-1]
            if dx == 2:
                written.append(
                    plots.plot_phase_portrait_2d(
                        dataset.hidden_test, inferred, self.path / "phase_portrait.png"
                    )
                )
            elif dx == 3:
                written.append(
                    plots.plot_trajectories_3d(
                        dataset.hidden_test, inferred, self.path / "trajectory_3d.png"
                    )
                )
        return [w for w in written if w is not None]
