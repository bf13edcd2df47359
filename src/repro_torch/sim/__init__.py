"""Virtual-time simulation layer of the port.

* ``Clock`` / ``WallClock`` / ``SimClock`` — the time source the trainer,
  the checkpoint plane, the telemetry and the whole control plane sleep,
  wait and stamp through. Production installs ``WallClock``; tests install
  a ``SimClock`` that jumps straight to the next pending deadline.
* ``EventQueue`` — deterministic ``(time, seq)`` priority queue.
* ``SimEngine`` — pure single-threaded discrete-event cluster simulation
  for large-scale deterministic scenarios (thousands of hosts, simulated
  weeks, byte-identical traces).
* ``sim/serve.py`` — ``ServeFleetEngine``, a SimEngine subclass that adds
  an autoscaled serving tier. Imported directly as
  ``repro_torch.sim.serve`` — not re-exported here, to keep this package
  free of a dependency on ``repro_torch.serve``.
"""
from repro_torch.sim.engine import InvariantViolation, SimEngine, SimJob
from repro_torch.sim.simtime import (TIME_SCALE, Clock, Event, EventQueue,
                                     SimClock, WallClock, active_clock,
                                     install_clock, use_clock)

__all__ = [
    "TIME_SCALE", "Clock", "Event", "EventQueue", "SimClock", "WallClock",
    "active_clock", "install_clock", "use_clock",
    "InvariantViolation", "SimEngine", "SimJob",
]
