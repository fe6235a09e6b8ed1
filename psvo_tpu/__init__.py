"""psvo_tpu — a JAX framework for variational sequential Monte Carlo.

A from-scratch rebuild of the capabilities of the reference `amoretti86/PSVO`
(see SURVEY.md): the full variational-SMC objective family (IWAE, FIVO/AESMC,
SVO, PSVO) for learning nonlinear state-space models, written as plain JAX
that XLA compiles for the GPU:

- Time is a `lax.scan`; batch and particle axes are plain tensor axes that
  shard over a `jax.sharding.Mesh(("data", "particle"))`.
- Neural proposal / transition / emission MLPs are plain matmul chains over
  all batch·particle rows.
- Resampling (multinomial + systematic) is a branch-free on-device
  inverse-CDF lookup + gather (`psvo_tpu.ops.resampling`).
- The PSVO FFBSi smoother is a second, reverse-time `lax.scan` over cached
  forward particles and log-weights.

Reference parity map: SURVEY.md §2 inventories the reference components
(`runner_flag.py`, `runner.py`, `model.py`, `distribution/`, `transformation/`,
`SMC/{SMC_base,IWAE,AESMC,SVO,PSVO}.py`, `trainer.py`, `rslts_saving/`); each
module here cites the component it covers.
"""

__version__ = "0.2.0"

import os as _os

# Persistent XLA compilation cache. Where JAX_COMPILATION_CACHE_DIR is set,
# JAX reads it itself and no directory is set here; otherwise the cache sits
# at a fixed path in the checkout, so every run of the same program from this
# checkout finds it again.
if not _os.environ.get("JAX_COMPILATION_CACHE_DIR"):
    import jax as _jax

    _checkout = _os.path.dirname(_os.path.dirname(_os.path.abspath(__file__)))
    _jax.config.update(
        "jax_compilation_cache_dir", _os.path.join(_checkout, ".jax_cache")
    )

from psvo_tpu import distributions
from psvo_tpu import networks
from psvo_tpu.data import Dataset, generate_dataset, load_dataset, save_dataset
from psvo_tpu.infer import filter_posterior, smooth_posterior
from psvo_tpu.smc import (
    FilterResult,
    forward_filter,
    forward_filter_segmented,
)
from psvo_tpu.train import Trainer, make_eval_step, make_optimizer, make_train_step
from psvo_tpu.config import (
    Config,
    DataConfig,
    MeshConfig,
    NetConfig,
    SMCConfig,
    TrainConfig,
    preset,
    PRESETS,
)
from psvo_tpu.models.ssm import SSM, init_ssm
from psvo_tpu.objectives import make_objective

__all__ = [
    "Config",
    "DataConfig",
    "Dataset",
    "FilterResult",
    "MeshConfig",
    "NetConfig",
    "PRESETS",
    "SMCConfig",
    "SSM",
    "TrainConfig",
    "Trainer",
    "distributions",
    "filter_posterior",
    "forward_filter",
    "forward_filter_segmented",
    "generate_dataset",
    "init_ssm",
    "load_dataset",
    "make_eval_step",
    "make_objective",
    "make_optimizer",
    "make_train_step",
    "networks",
    "preset",
    "save_dataset",
    "smooth_posterior",
]
