"""Each cell, those of BENCHMARK.json and those waiting for it
(`waiting_cells.json`), driven whole on the CPU at a small size, past the
harness's look for a chip: a sound run is correct; the control, and each fault the
cell can have planted in the timed path underneath, come out not correct.

Faults: a step that returns its state unchanged; half of the batch left
out (half of a dispatch's queries never reach the top-k); an
answer altered where it is produced (each found key written one off, or
the daemon answering one off); and for BSGS, hits decoded with the lane
count from before the dropout widened the lanes. A daemon query is one dispatch, so the
daemon's cell has no step whose state could stay unchanged; no cell has an
exchange between chips.
"""

import dataclasses

import pytest

from benchmark import harness
from benchmark.tests import waiting
from keyhunt_tpu_torch.io.results import ResultSink
from keyhunt_tpu_torch.ops import match
from keyhunt_tpu_torch.search.bsgs import BsgsEngine
from keyhunt_tpu_torch.search.engine import Engine
from keyhunt_tpu_torch.server import BsgsdServer

SEED = 2**33 + 12345          # past 32 bits: a seed may be
WALKER = {"pivots": 4, "width": 64, "steps": 2}
SMALL = {
    "bsgs-in16-sweep": ({"config": {"m": 1024, "lanes_total": 16, "steps": 2},
                         "traffic": {"targets": 4, "planted": 2, "window_bits": 24,
                                     "late": {"count": 1, "giant_bits": [10, 12], "lanes": 256},
                                     "warm_dispatches": 8}}, 30.0),
    "bsgsd-chunk2e40": ({"config": {"m": 4096, "lanes_total": 4096, "steps": 4},
                         "traffic": {"chunk_bits": 22, "chunks": 64, "pubkeys": 8,
                                     "hold_share": 0.5, "warm_queries": 1}}, 4.0),
    "walker-funded-2e22-endo": ({"config": WALKER,
                                 "traffic": {"targets": 300, "start_bits": [32, 48],
                                             "warm_dispatches": 0}}, 15.0),
    "walker-puzzle66": ({"config": WALKER, "traffic": {"warm_dispatches": 0}}, 4.0),
}


MAN = waiting.manifest()


def drive(name, tmp_path, control=False, trace=False):
    over, seconds = SMALL[name]
    return harness.run_cell(name, SEED, seconds, trace, device="cpu", overrides=over,
                            control=control, cache_dir=str(tmp_path), man=MAN)


@pytest.mark.parametrize("name", sorted(SMALL))
def test_sound_run_is_correct(name, tmp_path):
    line = drive(name, tmp_path)
    assert line["correct"], line["check"]
    assert list(line)[-1] == "check" and line["failed"] == 0
    assert line["attempted"] > 0
    for m in line["metrics"].values():
        assert m["value"] > 0


@pytest.mark.parametrize("name", sorted(SMALL))
def test_control_is_not_correct(name, tmp_path):
    line = drive(name, tmp_path, control=True)
    assert not line["correct"], line["check"]


@pytest.mark.parametrize("name,host_metrics", [
    ("bsgs-in16-sweep", {"table_ready_s"}),
    ("bsgsd-chunk2e40", {"table_ready_s", "query_p50_s.bsgsd"}),
    ("walker-puzzle66", set())])
def test_traced_run_reads_the_per_layer_metrics_it_can(name, host_metrics, tmp_path):
    """On the CPU the trace holds no device events: the device readers
    return nothing and leave their metrics out; the host's remain."""
    line = drive(name, tmp_path, trace=True)
    assert line["correct"]
    assert set(line["metrics"]) == host_metrics


def _unchanged_state(cls):
    dispatch = cls._dispatch

    if cls is BsgsEngine:
        def fault(self, state):
            return state, dispatch(self, state)[1]
    else:
        def fault(self, step_fn, px, py):
            return (px, py) + tuple(dispatch(self, step_fn, px, py)[2:])
    return fault


def _half_batch(fn, shape=None):
    """fn's mask with half of it cleared: the second half of its queries
    (BSGS: the later steps), or the upper half of the first axis of
    `shape` within every row (the daemon: a step's upper lanes; the
    walker: the upper pivots of every variant)."""
    def fault(mask, *args):
        mask = mask.clone()
        if shape is None:
            mask[mask.numel() // 2:] = False
        else:
            mask.view(-1, *shape)[:, shape[0] // 2:] = False
        return fn(mask, *args)
    return fault


def _altered_record(record):
    def fault(self, key, *args, **kw):
        return record(self, key + 1, *args, **kw)
    return fault


def _altered_answer(search):
    def fault(self, *args):
        key = search(self, *args)
        return None if key is None else key + 1
    return fault


def _decode_before_dropout(decode):
    """Once targets were dropped, decode as if the lanes had not widened."""
    def fault(self, c0, arr, K, D):
        if len(self._tmap) == self._n_all:
            return decode(self, c0, arr, K, D)
        cfg = self.cfg
        self.cfg = dataclasses.replace(cfg, lanes=cfg.lanes // 2)
        try:
            return decode(self, c0, arr, K, D)
        finally:
            self.cfg = cfg
    return fault


FAULTS = {
    ("bsgs-in16-sweep", "state"): lambda mp: mp.setattr(
        BsgsEngine, "_dispatch", _unchanged_state(BsgsEngine)),
    ("bsgs-in16-sweep", "half"): lambda mp: mp.setattr(
        match, "topk_with_payload", _half_batch(match.topk_with_payload)),
    ("bsgs-in16-sweep", "answer"): lambda mp: mp.setattr(
        ResultSink, "record", _altered_record(ResultSink.record)),
    ("bsgs-in16-sweep", "resized"): lambda mp: mp.setattr(
        BsgsEngine, "_decode", _decode_before_dropout(BsgsEngine._decode)),
    ("walker-funded-2e22-endo", "state"): lambda mp: mp.setattr(
        Engine, "_dispatch", _unchanged_state(Engine)),
    ("walker-funded-2e22-endo", "half"): lambda mp: mp.setattr(
        match, "topk_indices", _half_batch(match.topk_indices,
                                           (WALKER["pivots"], WALKER["width"]))),
    ("walker-funded-2e22-endo", "answer"): lambda mp: mp.setattr(
        ResultSink, "record", _altered_record(ResultSink.record)),
    ("walker-puzzle66", "state"): lambda mp: mp.setattr(
        Engine, "_dispatch", _unchanged_state(Engine)),
    ("walker-puzzle66", "answer"): lambda mp: mp.setattr(
        ResultSink, "record", _altered_record(ResultSink.record)),
    # a query's chunk fills the first half of its one dispatch's steps
    # (the rest sweeps past its end), so the daemon loses half its lanes
    ("bsgsd-chunk2e40", "half"): lambda mp: mp.setattr(
        match, "topk_with_payload", _half_batch(match.topk_with_payload, (256,))),
    ("bsgsd-chunk2e40", "answer"): lambda mp: mp.setattr(
        BsgsdServer, "search", _altered_answer(BsgsdServer.search)),
}


@pytest.mark.parametrize("name,fault", sorted(FAULTS))
def test_fault_is_not_correct(name, fault, tmp_path, monkeypatch):
    FAULTS[name, fault](monkeypatch)
    line = drive(name, tmp_path)
    assert not line["correct"], (fault, line["check"])
