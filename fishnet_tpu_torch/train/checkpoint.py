"""Training checkpoint and resume: the port of
``fishnet_tpu/train/checkpoint.py`` on ``torch.save``.

Training runs are hours long and not idempotent, so the full train state
(parameters, optimizer state, step) saves atomically — written to a
temporary file beside the target, then ``os.replace``d over it — and
restores bit for bit: a run resumed from a checkpoint continues as the
uninterrupted run would (on the CPU exactly; on the card as far as its
kernels are deterministic, which ``chip_smoke.py``'s train phase
measures). Works for both trainers (``TrainState`` and ``AzTrainState``
share their fields).

The format is the port's own (a ``torch.save`` file). The JAX package's
checkpoints are orbax directories, which cannot be read without orbax,
so they do not load here. The cross-package formats are the exported
nets: ``NnueWeights`` files (``Trainer.export``) and the AZ ``.npz``
(``AzTrainer.export``), which both packages serve.
"""

from __future__ import annotations

import os
import tempfile
from pathlib import Path
from typing import Union

import torch

from fishnet_tpu_torch.train.trainer import TrainState

__all__ = ["restore_checkpoint", "save_checkpoint"]

_FORMAT = "fishnet_tpu_torch.train.checkpoint/1"


def save_checkpoint(path: Union[str, Path], state: TrainState) -> None:
    """Atomically save a train state: parameters (CPU copies), the
    optimizer's ``state_dict`` and the step."""
    path = Path(path).resolve()
    payload = {
        "format": _FORMAT,
        "params": {name: p.detach().cpu().clone()
                   for name, p in state.params.named_parameters()},
        "optimizer": state.opt_state.state_dict(),
        "step": int(state.step),
    }
    fd, tmp = tempfile.mkstemp(prefix=path.name + ".", suffix=".tmp",
                               dir=str(path.parent))
    try:
        with os.fdopen(fd, "wb") as fp:
            torch.save(payload, fp)
        os.replace(tmp, path)
    except BaseException:
        try:
            os.unlink(tmp)
        except OSError:
            pass
        raise


def restore_checkpoint(path: Union[str, Path], template: TrainState) -> TrainState:
    """Restore into ``template`` (a freshly built state from
    ``Trainer.init`` / ``AzTrainer.init``): its parameters and optimizer
    take the saved values in place, on the template's device. Raises
    ``ValueError`` when the file is not a checkpoint of this format or
    its parameters do not match the template's."""
    path = Path(path).resolve()
    payload = torch.load(str(path), map_location="cpu", weights_only=True)
    if not isinstance(payload, dict) or payload.get("format") != _FORMAT:
        raise ValueError(f"{path}: not a fishnet_tpu_torch training checkpoint "
                         "(JAX checkpoints, orbax directories, do not load here)")
    net = template.params
    saved = payload["params"]
    names = dict(net.named_parameters())
    if set(saved) != set(names):
        raise ValueError(f"{path}: parameters {sorted(set(saved) ^ set(names))} "
                         "differ from the template's")
    with torch.no_grad():
        for name, p in names.items():
            if saved[name].shape != p.shape:
                raise ValueError(f"{path}: {name} has shape "
                                 f"{tuple(saved[name].shape)}, the template "
                                 f"{tuple(p.shape)}")
            p.copy_(saved[name])
    if hasattr(net, "_bf16"):
        net._bf16 = None  # the AZ net's serving cast copies are stale
    # load_state_dict casts the state's tensors to each parameter's
    # device (the step counters stay where the optimizer keeps them).
    template.opt_state.load_state_dict(payload["optimizer"])
    return TrainState(net, template.opt_state, int(payload["step"]))
