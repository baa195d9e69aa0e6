"""Named ranges for profiler traces of the search steps.

`span(name)` opens a `torch.profiler.record_function` range while a
profiler is running and is a null context otherwise (one flag read per
call), so the step functions carry their stage names at no cost. A trace
of a real dispatch then gives each stage's device time: the device time
of the kernels launched inside its range.
"""

from __future__ import annotations

import contextlib

import torch


def span(name: str):
    """A profiler range named `name`, or a null context with no profiler."""
    if torch.autograd._profiler_enabled():
        return torch.profiler.record_function(name)
    return contextlib.nullcontext()
