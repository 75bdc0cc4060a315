"""O(1) moving-window average filters (ring buffer, Neumaier sum).

Port of the JAX package's ``utils/filters.py`` (MovingWindowFilter,
filter.hpp:14-63). The reference divides by the FULL window size even
before the window fills (filter.hpp:38); so does this port.

A state holds any number of filters in lockstep: ``count`` and ``head``
have the filters' leading shape ``lead`` (a batch, or batch x legs), the
buffer is ``lead + (window,) + value_shape``, and the sums are
``lead + value_shape``. The window axis is therefore ``count.ndim``.
"""

from typing import NamedTuple

import torch


class MovingWindowState(NamedTuple):
    """Ring-buffer filter state (see the module docstring for shapes).

    Attributes:
      buffer: stored samples.
      sum: Neumaier running sum.
      correction: Neumaier compensation term.
      count: int32 number of valid samples (saturates at window).
      head: int32 next write slot.
    """
    buffer: torch.Tensor
    sum: torch.Tensor
    correction: torch.Tensor
    count: torch.Tensor
    head: torch.Tensor


def _neumaier_add(s, c, value):
    """One Neumaier-compensated accumulation step (filter.hpp:53-62)."""
    new_sum = s + value
    big_s = torch.abs(s) >= torch.abs(value)
    c = c + torch.where(big_s, (s - new_sum) + value, (value - new_sum) + s)
    return new_sum, c


def _window(state):
    return state.buffer.shape[state.count.ndim]


def moving_window_update(state, new_value):
    """Push ``new_value`` (lead + value_shape) into every filter; returns
    (new_state, average) with average = (sum + correction) / window."""
    nl = state.count.ndim
    window = _window(state)
    vshape = state.buffer.shape[nl + 1:]
    slot = (state.head % window).long()
    idx = slot.reshape(slot.shape + (1,) + (1,) * len(vshape)).expand(
        slot.shape + (1,) + tuple(vshape))
    evicted = torch.gather(state.buffer, nl, idx).squeeze(nl)
    full = (state.count >= window).reshape(
        state.count.shape + (1,) * len(vshape))
    # subtract the oldest sample only once the window is full
    s, c = _neumaier_add(state.sum, state.correction,
                         torch.where(full, -evicted,
                                     torch.zeros_like(evicted)))
    s, c = _neumaier_add(s, c, new_value)
    buffer = state.buffer.scatter(nl, idx, new_value.unsqueeze(nl))
    new_state = MovingWindowState(
        buffer=buffer, sum=s, correction=c,
        count=torch.clamp(state.count + 1, max=window),
        head=(state.head + 1) % window)
    return new_state, (s + c) / window


def moving_window_update_masked(state, new_value, mask):
    """Gated update: filters where ``mask`` (lead-shaped bool) is False
    keep their state and report their previous average — the reference's
    "only filter while in contact" pattern (A1RobotControl.cpp:274-281)
    and its height-gated terrain filter (:340-345)."""
    upd, avg_new = moving_window_update(state, new_value)

    def sel(a, b):
        m = mask.reshape(mask.shape + (1,) * (a.ndim - mask.ndim))
        return torch.where(m, a, b)

    new_state = MovingWindowState(*[sel(a, b) for a, b in zip(upd, state)])
    avg_old = (state.sum + state.correction) / _window(state)
    return new_state, sel(avg_new, avg_old)

