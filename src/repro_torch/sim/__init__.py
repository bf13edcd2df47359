"""Virtual-time layer of the port: the ``simtime`` clock protocol only.

``Clock`` / ``WallClock`` / ``SimClock`` — the time source the trainer,
the checkpoint plane and the telemetry stamp through. The reference's
discrete-event ``SimEngine`` is not part of this port.
"""
from repro_torch.sim.simtime import (TIME_SCALE, Clock, Event, EventQueue,
                                     SimClock, WallClock, active_clock,
                                     install_clock, use_clock)

__all__ = [
    "TIME_SCALE", "Clock", "Event", "EventQueue", "SimClock", "WallClock",
    "active_clock", "install_clock", "use_clock",
]
