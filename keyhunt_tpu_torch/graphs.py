"""CUDA graphs of a step's stages: captured once, each replayed inside the
`trace.span` of its stage.

A step called again and again at one shape pays the host's cost of every
launch on every call: the ctypes calls of the hand-written kernels, and
the ATen dispatch and allocator calls of the plain PyTorch between them.
`StageGraphs` captures the stages of such a step one graph each, in the
order they run, on one memory pool, and replays them in that order: a
stage's graph reads the outputs that the previous stage's graph left in
the pool, so a replay of the step is one graph launch a stage. Each
replay opens the span of the stage's name around its graph launch, so a
profiler trace ties the stage's kernels to its span through the launch's
correlation id, as it does an eager launch.

The kernel wrappers count their launches in Python (`_build.count_launch`),
which a replay does not run: a capture records what its stage counted
(`_build.recording_launches`) and launches nothing, and each replay adds
the record (`_build.add_launches`). So `_build.LAUNCHES` and
`LAUNCH_WIDTHS` count what the device ran, replayed or eager.

What to capture and when is the caller's (`search.bsgs.GiantStep`); CPU
tensors never capture (`capturable`).
"""

from __future__ import annotations

import dataclasses

import torch

from . import _build
from .trace import span


@dataclasses.dataclass
class Counts:
    """Captures of a step's graphs, and the calls that replayed them."""
    captures: int = 0
    replays: int = 0


def capturable(t: torch.Tensor) -> bool:
    """Whether work on `t`'s device can be captured as a CUDA graph."""
    return t.device.type == "cuda"


class StageGraphs:
    """The captured stages of one step at one shape, on `device`: capture
    them in order with `capture`, then `replay` them all, in that order."""

    def __init__(self, device: torch.device):
        self.device = device
        self.stages = []        # (span name, graph, launches by (kernel, width))
        self._pool = self._stream = None

    def capture(self, name: str, fn, *args):
        """Capture fn(*args) as the next stage's graph, named `name` (the
        stage's span); returns its outputs, which each replay rewrites in
        place. `args` must stay alive as long as the graphs: the graph
        reads them where they lie."""
        with _build.recording_launches() as launches:
            graph, outs = self._capture(fn, args)
        self.stages.append((name, graph, launches))
        return outs

    def _capture(self, fn, args):
        """(graph, outputs) of fn(*args) captured on a side stream into the
        pool that every stage of this step shares."""
        if self._pool is None:
            self._pool = torch.cuda.graph_pool_handle()
            self._stream = torch.cuda.Stream(self.device)
        graph = torch.cuda.CUDAGraph()
        here = torch.cuda.current_stream(self.device)
        self._stream.wait_stream(here)
        with torch.cuda.device(self.device), torch.cuda.stream(self._stream):
            # thread_local: another thread's CUDA calls (the daemon's) do
            # not fail this capture
            graph.capture_begin(pool=self._pool, capture_error_mode="thread_local")
            try:
                outs = fn(*args)
            finally:
                graph.capture_end()
        here.wait_stream(self._stream)
        return graph, outs

    def replay(self) -> None:
        """Launch every stage's graph on the current stream, each inside
        its span, and count its kernels' launches."""
        for name, graph, launches in self.stages:
            with span(name):
                graph.replay()
            _build.add_launches(launches)
