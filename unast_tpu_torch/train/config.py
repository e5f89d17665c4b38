"""The train step's arguments, as the JAX package's CLI gives them.

`train_args` fills a namespace with the JAX parser's defaults
(unast_tpu/train/config.py::build_parser, copied here for the keys the
train step reads) and then the flat keys of a config JSON (configs/*.json),
as parse_with_config does without CLI flags. Keys the train step does not
read are carried over from the JSON as they are.
"""

import json
import types

# unast_tpu/train/config.py::build_parser defaults of the keys the step reads
TRAIN_DEFAULTS = {
    "epochs": 300,
    "epoch_steps": 50,
    "train_batch_size": 4,
    "lr": 0.0625,
    "weight_decay": 1e-6,
    "optim_type": "adamw",
    "sched_type": "transformer",
    "warmup_steps": 2000,
    "lr_milestones": [100, 200],
    "lr_gamma": 0.5,
    "grad_clip": 1.0,
    "ema_decay": 0.0,
    "ae_steps": 4,
    "cm_steps": 8,
    "sp_steps": 4,
    "d_steps": 4,
    "s_eos_weight": 5.0,
    "t_eos_weight": 1.0,
    "ga_weight": 0.0,
    "ga_sigma": 0.2,
    "data_mel_len": 816,
    "data_text_len": 304,
    "cm_infer_mel_len": 0,
    "cm_infer_text_len": 0,
    "cm_text_decode": "ar",
    "param_sum_metric": False,
}


def train_args(path=None, **overrides) -> types.SimpleNamespace:
    """The defaults, then the config JSON at `path` (if any), then
    `overrides`."""
    d = dict(TRAIN_DEFAULTS)
    if path is not None:
        with open(path, "r", encoding="utf-8") as f:
            d.update(json.load(f))
    d.update(overrides)
    return types.SimpleNamespace(**d)
