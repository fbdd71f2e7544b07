"""Device selection for the port's entry points.

Every entry point runs on the GPU unless its caller asks for the CPU:
``resolve_device(None)`` is ``cuda``, and asking for ``cuda`` on a
machine without a visible GPU raises instead of quietly running the
search on the CPU (a CPU run of a GPU deployment is a different
deployment, not a slower one).
"""

from __future__ import annotations

import contextlib
from typing import ContextManager, Union

import torch

DeviceLike = Union[str, torch.device, None]


def on_device(device: torch.device) -> ContextManager:
    """Make ``device`` the calling thread's current CUDA device for the
    block (a no-op for the CPU). The CUDA runtime launches kernels,
    records events and picks the current stream on the calling thread's
    current device, so work for ``cuda:N`` from a thread whose current
    device is another card runs under this guard."""
    if device.type == "cuda":
        return torch.cuda.device(device)
    return contextlib.nullcontext()


def resolve_device(device: DeviceLike = None) -> torch.device:
    """The torch device an entry point should run on: ``"cuda"`` by
    default, ``"cpu"`` only when asked for. Raises ``RuntimeError`` for
    a CUDA device when no GPU is visible, and ``ValueError`` for device
    types the port does not run on."""
    dev = torch.device("cuda" if device is None else device)
    if dev.type == "cuda":
        if not torch.cuda.is_available():
            raise RuntimeError(
                "no CUDA device is visible; pass device='cpu' "
                "(--device cpu) to run on the CPU"
            )
        if dev.index is None:
            dev = torch.device("cuda", torch.cuda.current_device())
        return dev
    if dev.type != "cpu":
        raise ValueError(f"unsupported device type: {dev.type!r}")
    return dev

