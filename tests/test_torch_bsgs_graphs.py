"""The capture policy of the one-device BSGS step (`search.bsgs.GiantStep`,
`graphs.StageGraphs`) on the CPU.

CPU tensors never capture. Everything else runs with a stand-in for the
CUDA graph (`_StandIn`): its capture records the stage's function and
arguments and computes nothing that lasts, and its replay runs the
function again, with no launch counted, and writes the results into the
captured outputs, as a graph's replay rewrites its static outputs. With
it the tests check that:
- a step captures once a shape after `GRAPH_AFTER_CALLS` eager calls, and
  its replays give the eager step's lanes and payload, across two shapes
  and a re-seed in between;
- the launches a replay counts are those an eager call counts;
- `_set_step` and `_set_pass` drop the graphs, and `_rerun`'s wide step
  fns and the mesh's step stay eager;
- `graph_captures` and `graph_replays` count as documented.
The card's own graphs: tests/test_torch_graphs_cuda.py.
"""

import gc
import os
import weakref

import numpy as np
import pytest
import torch

from keyhunt_tpu_torch import _build, graphs
from keyhunt_tpu_torch.io.results import ResultSink
from keyhunt_tpu_torch.ops import match
from keyhunt_tpu_torch.ref import ecc
from keyhunt_tpu_torch.search import bsgs

M = 256
CPU = torch.device("cpu")


@pytest.fixture(scope="module")
def table():
    return bsgs.build_baby_table(M, pivots=2, width=32, steps=2, device="cpu")


def _tensors(outs):
    return outs if isinstance(outs, tuple) else (outs,)


class _StandIn:
    """A CUDA graph's stand-in on the CPU (module docstring)."""

    def __init__(self, fn, args, outs):
        self.fn, self.args, self.outs = fn, args, outs

    def replay(self):
        with _build.recording_launches():       # a replay runs no Python
            outs = self.fn(*self.args)
        for buf, new in zip(_tensors(self.outs), _tensors(outs)):
            if buf is not new:
                buf.copy_(new)


def _stand_in_capture(self, fn, args):
    saved = [a.clone() for a in args]
    outs = fn(*args)                 # the outputs' buffers
    for a, s in zip(args, saved):    # a capture computes nothing
        a.copy_(s)
    return _StandIn(fn, args, outs), outs


@pytest.fixture
def stand_in(monkeypatch):
    monkeypatch.setattr(graphs, "capturable", lambda t: True)
    monkeypatch.setattr(graphs.StageGraphs, "_capture", _stand_in_capture)


def _engine(tbl, keys, tmp_path, end=1 << 40, devices=None, **kw):
    cfg = bsgs.BsgsConfig(m=tbl.m, lanes=4, steps=2, **kw)
    sink = ResultSink(path=os.path.join(tmp_path, "found.txt"), quiet=True)
    return bsgs.BsgsEngine(cfg, tbl, [ecc.pubkey(k) for k in keys], 1, end,
                           sink=sink, quiet=True, device="cpu", devices=devices)


def _lanes(cfg, keys, c0):
    px, py = bsgs.seed_lanes(cfg, [ecc.pubkey(k) for k in keys], c0)
    z = np.zeros_like(px)
    z[0] = 1
    return tuple(torch.from_numpy(a.view(np.int32)) for a in (px, py, z))


def _calls(step, cfg, keys, c0s):
    """Call `step` from fresh lanes at each c0 of `c0s` (None: go on from
    the last call's lanes), copying every output out."""
    out, state = [], None
    for c0 in c0s:
        if c0 is not None:
            state = _lanes(cfg, keys, c0)
        *state, payload = step(*state)
        out.append([t.clone() for t in (*state, payload)])
    return out


def test_cpu_tensors_never_capture(table, tmp_path):
    cfg = bsgs.BsgsConfig(m=M, lanes=4, steps=2)
    step = bsgs.make_giant_step_fn(cfg, table.resident([CPU]))
    _calls(step, cfg, [3000, 5000], [1 + M, None, None, None, None, None])
    assert step._captured is None
    assert (step.counts.captures, step.counts.replays) == (0, 0)
    eng = _engine(table, [1 << 60], tmp_path)        # not in the range
    eng.run(max_keys=6 * eng.cfg.keys_per_call(1))
    assert eng.dispatches == 6
    assert (eng.graph_captures, eng.graph_replays) == (0, 0)


def test_replays_equal_eager_across_shapes_and_a_reseed(table, stand_in):
    """Six calls of one shape (a re-seed after the fourth) and four of
    another: the replayed step's lanes and payload are the eager step's,
    bit for bit, and it captured once a shape."""
    res = table.resident([CPU])
    runs = {}
    for capture in (False, True):
        out = []
        for keys, lanes in (([3000, 5000], 4), ([3000, 5000, 7000, 70000], 2)):
            cfg = bsgs.BsgsConfig(m=M, lanes=lanes, steps=2)
            step = bsgs.make_giant_step_fn(cfg, res, capture=capture)
            c0s = [1 + M, None, None, None, 1 + 9 * M, None][:6 if lanes == 4 else 4]
            out += _calls(step, cfg, keys, c0s)
            assert step.counts.captures == (1 if capture else 0)
            assert step.counts.replays == (len(c0s) - 2 if capture else 0)
        runs[capture] = out
    assert len(runs[True]) == 10
    for got, want in zip(runs[True], runs[False]):
        for g, w in zip(got, want):
            assert torch.equal(g, w)
    assert any(int(p[-1][2 * 4]) > 0 for p in runs[False])    # some call hit


def test_a_new_shape_is_counted_afresh(table, stand_in):
    """One step fn called at one shape, then another, then the first:
    each shape runs eagerly GRAPH_AFTER_CALLS times before its capture."""
    res = table.resident([CPU])
    cfg = bsgs.BsgsConfig(m=M, lanes=4, steps=2)
    step = bsgs.make_giant_step_fn(cfg, res)
    wide = _lanes(cfg, [3000, 5000], 1 + M)
    narrow = _lanes(cfg, [3000], 1 + M)
    for lanes, captures in ((wide, 1), (narrow, 2), (wide, 3)):
        for _ in range(bsgs.GRAPH_AFTER_CALLS):
            step(*lanes)
            assert step.counts.captures == captures - 1
        step(*lanes)
        assert step.counts.captures == captures
    assert step.counts.replays == 3


def test_replay_counts_the_launches_of_an_eager_call(stand_in):
    """A stage that counts a launch: eager calls count it, the capture
    does not, each replay counts it once."""
    def stage(x):
        _build.count_launch("test_stage", (int(x.shape[0]), 3))
        return x * 2 + 1
    key = ("test_stage", (5, 3))
    x = torch.arange(5)
    before = _build.LAUNCH_WIDTHS[key], _build.LAUNCHES["test_stage"]
    try:
        stage(x)
        assert _build.LAUNCH_WIDTHS[key] - before[0] == 1
        g = graphs.StageGraphs(CPU)
        y = g.capture("test.stage", stage, x)
        assert _build.LAUNCH_WIDTHS[key] - before[0] == 1
        for n in range(2, 5):
            x.add_(1)
            g.replay()
            assert torch.equal(y, x * 2 + 1)
            assert _build.LAUNCH_WIDTHS[key] - before[0] == n
            assert _build.LAUNCHES["test_stage"] - before[1] == n
    finally:
        _build.LAUNCH_WIDTHS.pop(key, None)
        _build.LAUNCHES.pop("test_stage", None)


def test_engine_counts_probe_launches_per_dispatch(table, tmp_path, stand_in,
                                                    monkeypatch):
    """An engine whose probe counts a launch as P1's wrapper does: one a
    dispatch, replayed or eager; the key is found; graph_replays counts the
    dispatches past the eager calls (one target: no dropout, one shape)."""
    probe = match.probe_buckets_packed

    def counted(slab, w0, *args):
        _build.count_launch("probe_packed", (int(w0.shape[0]), slab.shape[1]))
        return probe(slab, w0, *args)
    monkeypatch.setattr(match, "probe_buckets_packed", counted)
    keys = [1 + M + 2 * M * 8 * 9 + 5]       # in the tenth dispatch
    eng = _engine(table, keys, tmp_path, end=1 + M + 2 * M * 100)
    # a payload in flight is a copy, as the card's fetch makes it: the
    # next replay rewrites the step's own
    monkeypatch.setattr(eng, "_fetch_async", lambda payload: (payload.clone(), None))
    before = _build.LAUNCHES["probe_packed"]
    found = eng.run()
    assert sorted(found.values()) == sorted(keys)
    assert _build.LAUNCHES["probe_packed"] - before == eng.dispatches
    assert eng.dispatches >= 10
    assert eng.graph_captures == 1
    assert eng.graph_replays == eng.dispatches - bsgs.GRAPH_AFTER_CALLS


def test_set_step_and_set_pass_drop_the_graphs(table, tmp_path, stand_in):
    eng = _engine(table, [3000, 40000], tmp_path, table_partitions=2)
    state = eng._seed(1 + M)

    def captured():
        s = state
        for _ in range(bsgs.GRAPH_AFTER_CALLS + 1):
            s = eng._dispatch(s)[0]
        assert eng.step_fn._captured is not None
        return weakref.ref(eng.step_fn._captured)

    for drop in (eng._set_step, lambda: eng._set_pass(eng._passes[1])):
        old = captured()
        drop()
        gc.collect()
        assert old() is None
        assert eng.step_fn._captured is None and eng.step_fn._calls == 0
    assert eng.graph_captures == 2 and eng.graph_replays == 2


def test_rerun_step_fns_stay_eager(table, tmp_path, stand_in):
    eng = _engine(table, [3000, 40000], tmp_path)
    for _ in range(bsgs.GRAPH_AFTER_CALLS + 2):
        eng._rerun(1 + M, nhits=9, flags_full=False)
    (wide,) = eng._wide_fns.values()
    assert wide.capture is False and wide._captured is None
    assert (eng.graph_captures, eng.graph_replays) == (0, 0)


def test_mesh_step_stays_eager(table, tmp_path, stand_in):
    keys = [1 + M + 2 * M * 37]
    eng = _engine(table, keys, tmp_path, end=1 + M + 2 * M * 200, devices=2)
    assert sorted(eng.run().values()) == keys
    assert eng.dispatches > bsgs.GRAPH_AFTER_CALLS
    assert not isinstance(eng.step_fn, bsgs.GiantStep)
    assert (eng.graph_captures, eng.graph_replays) == (0, 0)
