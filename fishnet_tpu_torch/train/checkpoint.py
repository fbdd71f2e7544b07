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

A checkpoint holds the gathered, mesh-free layout: every parameter and
every optimizer-state tensor under its single-device name and shape
(format 2; format 1, the optimizer's own ``state_dict`` of a
single-device trainer, still reads). ``restore_checkpoint`` places each
one like the template's — sharded over a ``Mesh`` (``train/sharding.py``)
or not — so a run saved from a sharded trainer resumes in a
single-device one and the other way round, as the JAX package's orbax
restore places arrays on the template's shardings.

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
from typing import Dict, List, Union

import torch

from fishnet_tpu_torch.train.sharding import gather_state, module_layout, scatter_state
from fishnet_tpu_torch.train.trainer import TrainState

__all__ = ["restore_checkpoint", "save_checkpoint"]

_FORMAT = "fishnet_tpu_torch.train.checkpoint/2"
_FORMAT_V1 = "fishnet_tpu_torch.train.checkpoint/1"


def _leaf_order(opt: torch.optim.Optimizer) -> List[torch.Tensor]:
    """The optimizer's parameters in its ``state_dict`` index order."""
    return [p for group in opt.param_groups for p in group["params"]]


def _groups(opt: torch.optim.Optimizer) -> List[dict]:
    """The optimizer's hyperparameters, per group, without its
    parameter indices."""
    return [{k: v for k, v in g.items() if k != "params"}
            for g in opt.state_dict()["param_groups"]]


def save_checkpoint(path: Union[str, Path], state: TrainState) -> None:
    """Atomically save a train state: parameters and the optimizer's
    per-parameter state in the gathered layout (CPU copies), its
    hyperparameters and the step."""
    path = Path(path).resolve()
    net, opt = state.params, state.opt_state
    params: Dict[str, torch.Tensor] = {}
    opt_state: Dict[str, Dict[str, object]] = {}
    for name, leaves in module_layout(net):
        params[name] = gather_state(net, name, leaves)
        per_leaf = [opt.state.get(leaf, {}) for leaf in leaves]
        entry: Dict[str, object] = {}
        for key, value in per_leaf[0].items():
            if isinstance(value, torch.Tensor) and value.shape == leaves[0].shape:
                entry[key] = gather_state(net, name, [s[key] for s in per_leaf])
            else:  # a step counter: one value for every slice
                entry[key] = (value.detach().cpu().clone()
                              if isinstance(value, torch.Tensor) else value)
        if entry:
            opt_state[name] = entry
    payload = {
        "format": _FORMAT,
        "params": params,
        "optimizer": {"state": opt_state, "param_groups": _groups(opt)},
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


def _named_v1_state(payload: dict) -> dict:
    """A format-1 optimizer ``state_dict`` (indices in the single-device
    module's parameter order) keyed by parameter name."""
    names = list(payload["params"])
    sd = payload["optimizer"]
    return {"state": {names[i]: st for i, st in sd["state"].items()},
            "param_groups": [{k: v for k, v in g.items() if k != "params"}
                             for g in sd["param_groups"]]}


def restore_checkpoint(path: Union[str, Path], template: TrainState) -> TrainState:
    """Restore into ``template`` (a freshly built state from
    ``Trainer.init`` / ``AzTrainer.init``, sharded or not): its
    parameters and optimizer take the saved values in place, placed like
    the template's. Raises ``ValueError`` when the file is not a
    checkpoint of this format or its parameters do not match the
    template's."""
    path = Path(path).resolve()
    payload = torch.load(str(path), map_location="cpu", weights_only=True)
    fmt = payload.get("format") if isinstance(payload, dict) else None
    if fmt not in (_FORMAT, _FORMAT_V1):
        raise ValueError(f"{path}: not a fishnet_tpu_torch training checkpoint "
                         "(JAX checkpoints, orbax directories, do not load here)")
    saved = payload["params"]
    saved_opt = (payload["optimizer"] if fmt == _FORMAT
                 else _named_v1_state(payload))
    net, opt = template.params, template.opt_state
    layout = module_layout(net)
    names = [name for name, _ in layout]
    if set(saved) != set(names):
        raise ValueError(f"{path}: parameters {sorted(set(saved) ^ set(names))} "
                         "differ from the template's")
    index = {id(p): i for i, p in enumerate(_leaf_order(opt))}
    state: Dict[int, Dict[str, object]] = {}
    with torch.no_grad():
        for name, leaves in layout:
            full, want = saved[name], _gathered_shape(net, name, leaves)
            if tuple(full.shape) != want:
                raise ValueError(f"{path}: {name} has shape "
                                 f"{tuple(full.shape)}, the template {want}")
            for leaf, part in zip(leaves, scatter_state(net, name, full)):
                leaf.copy_(part)
            entry = saved_opt["state"].get(name)
            if not entry:
                continue
            split = {k: (scatter_state(net, name, v) if isinstance(v, torch.Tensor)
                         and tuple(v.shape) == want else None)
                     for k, v in entry.items()}
            for m, leaf in enumerate(leaves):
                state[index[id(leaf)]] = {
                    k: (split[k][m] if split[k] is not None
                        else v.clone() if isinstance(v, torch.Tensor) else v)
                    for k, v in entry.items()}
    if hasattr(net, "_bf16"):
        net._bf16 = None  # the AZ net's serving cast copies are stale
    groups = opt.state_dict()["param_groups"]
    for group, hyper in zip(groups, saved_opt["param_groups"]):
        group.update(hyper)
    # load_state_dict casts the state's tensors to each parameter's
    # device (the step counters stay where the optimizer keeps them).
    opt.load_state_dict({"state": state, "param_groups": groups})
    return TrainState(net, opt, int(payload["step"]))


def _gathered_shape(net, name: str, leaves) -> tuple:
    """``name``'s shape in the gathered layout."""
    shapes = getattr(net, "shapes", None)
    return tuple(shapes[name]) if shapes is not None else tuple(leaves[0].shape)
