"""The self-tuning control plane: the loop from telemetry back to the
scheduling knobs — the port of ``fishnet_tpu/control/``.

* :mod:`fishnet_tpu_torch.control.signals` — folds the in-process
  telemetry sources (stage durations through the span recorder's
  stage-observer slot, SLO burn rates, the cost books, the coalescer's
  occupancy, the shards' rungs, the AZ plane's fill, the lanes' depths)
  into windowed, hysteresis-smoothed :class:`ControlSignals`;
* :mod:`fishnet_tpu_torch.control.actuators` — the typed actuator
  registry: every subsystem exports a bounded, revertible setter, and
  every actuation bumps ``fishnet_control_actuations_total{knob,
  direction}`` and records a ``control`` span;
* :mod:`fishnet_tpu_torch.control.controller` — the deterministic
  rule/probe policy behind the :class:`Policy` protocol, and the loop
  around it. No wall clock and no randomness on the decision path:
  decisions are a pure function of the signal window.

A library, as in the JAX package (whose only caller is ``bench.py
--control``): no CLI flag builds a controller. ``FISHNET_NO_CONTROL=1``
is the escape hatch — a built controller stops deciding, every actuator
refuses to move, and ``revert()`` restores each subsystem's static
default. The controller only moves scheduling knobs (which groups share
a launch of the FT-gather kernel, how many launches are in flight, the
shed watermarks, the DRR weights, the prefetch and speculation pins, the
MCTS leaf-width ceiling), never numerics, so analyses stay bit-identical
with it on.
"""

from __future__ import annotations

import os

#: Escape hatch: disables every decision and actuation while leaving
#: the wiring inert, so setting it restores the static defaults.
NO_CONTROL_ENV = "FISHNET_NO_CONTROL"


def control_enabled() -> bool:
    """Whether the control plane may decide and actuate. One env read a
    control window, never a serving-path read."""
    return os.environ.get(NO_CONTROL_ENV, "0") != "1"


from fishnet_tpu_torch.control.actuators import (  # noqa: E402,F401 - public API
    Actuation,
    Actuator,
    ActuatorRegistry,
)
from fishnet_tpu_torch.control.controller import (  # noqa: E402,F401 - public API
    Action,
    Controller,
    LadderProbe,
    Policy,
    RuleProbePolicy,
    build_controller,
    shutdown_controller,
    standard_actuators,
)
from fishnet_tpu_torch.control.signals import (  # noqa: E402,F401 - public API
    ControlSignals,
    HysteresisSwitch,
    SignalCollector,
)
