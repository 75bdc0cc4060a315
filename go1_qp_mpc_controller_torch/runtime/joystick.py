"""Joystick command sources for the host control loop.

The port's copy of the JAX package's ``runtime/joystick.py``. The
reference's operator path is a /joy subscription whose callback maps raw
axes and buttons into desired-state commands consumed by main_update
(GazeboA1ROS.cpp:117-188, 381-415). The host loop instead polls a command
source once per fast tick; each returned sample runs through the mapping
chain ``command.axes_from_raw -> clamp_axes -> latch_buttons ->
apply_commands`` in the fast step (runtime/loop.py).

A source is any object with ``poll() -> list[(raw_axes (8,) float,
raw_buttons (>=5,) int)]``; an empty list means "no new samples, keep
applying the last ones", as the reference's main_update keeps consuming
the last joy_cmd_* values between callbacks.
"""

import threading


class ScriptedJoySource:
    """Replays a scripted sequence of joystick samples keyed by poll count.

    The host loop polls once per fast tick, so event ticks are fast-tick
    indices: the deterministic stand -> walk -> stop driver of the tests
    and of ``main.py loop --joy-demo``.

    Args:
      events: list of (tick, raw_axes (8,), raw_buttons (>=5,)), in any
        order; every event with tick <= the current poll count is
        delivered exactly once, in tick order.
    """

    def __init__(self, events):
        self._events = sorted(events, key=lambda e: e[0])
        self._next = 0
        self._polls = 0

    def poll(self):
        out = []
        while (self._next < len(self._events)
               and self._events[self._next][0] <= self._polls):
            _, axes, buttons = self._events[self._next]
            out.append((axes, buttons))
            self._next += 1
        self._polls += 1
        return out


class QueueJoySource:
    """Thread-safe push-based source: a driver thread pushes samples, the
    control loop drains them (the shape a /joy or SDK wireless-handle
    integration feeds)."""

    def __init__(self):
        self._lock = threading.Lock()
        self._samples = []

    def push(self, raw_axes, raw_buttons):
        with self._lock:
            self._samples.append((raw_axes, raw_buttons))

    def poll(self):
        with self._lock:
            out = self._samples
            self._samples = []
        return out
