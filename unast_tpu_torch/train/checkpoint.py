"""Checkpoints of the port, mirroring `unast_tpu/train/checkpoint.py` (the
reference's save_ckp / load_ckp, src/utils.py:139-195): the same four file
roles (model_temporary, model_most_recent, model_best, model_<epoch>) and
the same `.meta.json` sidecar (epoch + 1, the best metric, the step
generator's seed pair).

A checkpoint is one `torch.save` file of the TrainState as plain nested
dicts and lists of tensors and ints (NamedTuples become dicts of their
fields), so it loads with `torch.load(weights_only=True)`. load_ckp rebuilds
the TrainState on a template's structure and devices, as JAX restores onto
an abstract template, and refuses a file whose tree differs from it.
Files are written to a temporary name and renamed, so a reader never sees
half a checkpoint.

async_save=True copies the state to host memory before it returns (so the
next train step may change the live tensors) and writes the file on a
background thread; one save is in flight at a time, and wait_for_saves
drains it.
"""

import json
import os
import threading
from typing import Optional, Tuple

import numpy as np
import torch

from .steps import TrainState


def _roles(checkpoint_path: str, epoch: int, temporary: bool, epoch_save: bool):
    if temporary:
        return [os.path.join(checkpoint_path, "model_temporary.ckpt")]
    if epoch_save:
        return [os.path.join(checkpoint_path, f"model_{epoch}.ckpt")]
    return [os.path.join(checkpoint_path, "model_most_recent.ckpt")]


def _plain(x):
    """x as nested dicts and lists of CPU tensors and ints (a copy: the
    host snapshot of an async save)."""
    if isinstance(x, tuple) and hasattr(x, "_fields"):
        return {k: _plain(v) for k, v in x._asdict().items()}
    if isinstance(x, dict):
        return {k: _plain(v) for k, v in x.items()}
    if isinstance(x, (list, tuple)):
        return [_plain(v) for v in x]
    if isinstance(x, torch.Tensor):
        return x.detach().to("cpu", copy=True)
    return int(x)


def _restore(template, x, where="state"):
    """x (as _plain made it) rebuilt on template's structure, each tensor
    on its template's device; raises ValueError where they differ."""
    if isinstance(template, tuple) and hasattr(template, "_fields"):
        return type(template)(**_restore(template._asdict(), x, where))
    if isinstance(template, dict):
        if not isinstance(x, dict) or set(x) != set(template):
            raise ValueError(f"checkpoint tree differs from the template at {where}")
        return {k: _restore(v, x[k], f"{where}/{k}") for k, v in template.items()}
    if isinstance(template, (list, tuple)):
        if not isinstance(x, list) or len(x) != len(template):
            raise ValueError(f"checkpoint tree differs from the template at {where}")
        return type(template)(_restore(t, v, f"{where}/{i}")
                              for i, (t, v) in enumerate(zip(template, x)))
    if isinstance(template, torch.Tensor):
        if (not isinstance(x, torch.Tensor) or x.shape != template.shape
                or x.dtype != template.dtype):
            raise ValueError(f"checkpoint leaf {where} differs from the template")
        return x.to(template.device)
    return int(x)


def _write(state, path: str, meta: dict):
    tmp = path + ".tmp"
    torch.save(state, tmp)
    os.replace(tmp, path)
    with open(tmp, "w") as f:
        json.dump(meta, f)
    os.replace(tmp, path + ".meta.json")


class _Saver:
    """The one background writer of async saves."""

    def __init__(self):
        self._thread: Optional[threading.Thread] = None
        self._error: Optional[BaseException] = None

    def wait(self):
        if self._thread is not None:
            self._thread.join()
            self._thread = None
        if self._error is not None:
            err, self._error = self._error, None
            raise err

    def start(self, jobs):
        self.wait()

        def run():
            try:
                for job in jobs:
                    _write(*job)
            except BaseException as e:  # raised again by the next wait()
                self._error = e
        self._thread = threading.Thread(target=run, daemon=True)
        self._thread.start()


_SAVER = _Saver()


def wait_for_saves():
    """unast_tpu/train/checkpoint.py::wait_for_saves: block until the
    in-flight async save (if any) is on disk; re-raise its error."""
    _SAVER.wait()


def save_ckp(epoch: int, valid_metric: float, ts: TrainState, is_best: bool,
             checkpoint_path: str, temporary_save: bool = False,
             epoch_save: bool = False, rng=None, async_save: bool = False):
    """unast_tpu/train/checkpoint.py::save_ckp: write ts to its role's file
    (and to model_best.ckpt when is_best, for the most-recent role), with
    the sidecar {"epoch": epoch + 1, "valid_loss_min", "rng"}. rng: the
    step generator's seed pair, or None."""
    os.makedirs(checkpoint_path, exist_ok=True)
    meta = {"epoch": epoch + 1, "valid_loss_min": float(valid_metric),
            "rng": np.asarray(rng).tolist() if rng is not None else None}
    paths = _roles(checkpoint_path, epoch, temporary_save, epoch_save)
    if is_best and not temporary_save and not epoch_save:
        paths.append(os.path.join(checkpoint_path, "model_best.ckpt"))
    _SAVER.wait()
    state = _plain(ts)
    jobs = [(state, path, meta) for path in paths]
    if async_save:
        _SAVER.start(jobs)
    else:
        for job in jobs:
            _write(*job)


def load_ckp(ckpt_fpath: str, template: TrainState
             ) -> Tuple[int, float, TrainState, Optional[np.ndarray]]:
    """unast_tpu/train/checkpoint.py::load_ckp: (epoch, best metric,
    TrainState, rng seed pair or None). `template` is a freshly initialized
    TrainState of the same config and optimizer, on the devices the
    restored tensors go to."""
    wait_for_saves()
    if not os.path.exists(ckpt_fpath):
        raise FileNotFoundError(f"no checkpoint at {ckpt_fpath}")
    # a save directory (save_ckp's checkpoint_path) means its best checkpoint
    if (os.path.isdir(ckpt_fpath)
            and not os.path.exists(ckpt_fpath + ".meta.json")):
        inner = os.path.join(ckpt_fpath, "model_best.ckpt")
        if os.path.exists(inner + ".meta.json"):
            ckpt_fpath = inner
    ts = _restore(template, torch.load(ckpt_fpath, map_location="cpu",
                                       weights_only=True))
    with open(ckpt_fpath + ".meta.json") as f:
        meta = json.load(f)
    rng = (np.asarray(meta["rng"], np.int64)
           if meta.get("rng") is not None else None)
    return meta["epoch"], meta["valid_loss_min"], ts, rng
