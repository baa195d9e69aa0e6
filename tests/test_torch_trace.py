"""The port's spans (keyhunt_tpu_torch.trace) on the CPU: the per-name
table of counts, totals and self times, per-thread stacks, the profiler
range each span opens while a profiler runs; the spans of the BSGS and
walker engines, the baby table and the daemon; the operator's line of the
CLI; and the benchmark's four readers of them."""

import os
import re
import threading
import time

import pytest
import torch
from torch.profiler import ProfilerActivity, profile

from benchmark import harness
from keyhunt_tpu_torch import cli, server, trace
from keyhunt_tpu_torch.io.results import ResultSink
from keyhunt_tpu_torch.io.targets import load_hash160_file
from keyhunt_tpu_torch.ref import ecc
from keyhunt_tpu_torch.ref.hashes import hash160
from keyhunt_tpu_torch.search import bsgs
from keyhunt_tpu_torch.search.engine import Engine
from keyhunt_tpu_torch.search.walker import WalkerConfig
from keyhunt_tpu_torch.trace import span

M = 256              # tiny baby table: stride 512 keys


@pytest.fixture(autouse=True)
def fresh():
    trace.reset()
    yield
    trace.reset()


@pytest.fixture(scope="module")
def table():
    return bsgs.build_baby_table(M, pivots=2, width=32, steps=2, device="cpu")


def _engine(tbl, keys, tmp_path, lanes=4, steps=2):
    cfg = bsgs.BsgsConfig(m=tbl.m, lanes=lanes, steps=steps)
    sink = ResultSink(path=os.path.join(tmp_path, "found.txt"), quiet=True)
    return bsgs.BsgsEngine(cfg, tbl, [ecc.pubkey(k) for k in keys], 1, 16384,
                           sink=sink, quiet=True, device="cpu")


def _events(prof):
    return [(e.name(), e.start_ns(), e.start_ns() + e.duration_ns())
            for e in prof.profiler.kineto_results.events()]


def test_nested_spans_count_total_and_self():
    for _ in range(2):
        with span("t.outer"):
            time.sleep(0.002)
            with span("t.inner"):
                time.sleep(0.003)
            with span("t.inner"):
                pass
    tot = trace.totals()
    outer, inner = tot["t.outer"], tot["t.inner"]
    assert (outer["count"], inner["count"]) == (2, 4)
    assert outer["self_ns"] == outer["total_ns"] - inner["total_ns"]
    assert inner["self_ns"] == inner["total_ns"] >= 6_000_000
    assert outer["self_ns"] >= 4_000_000


def test_threads_keep_separate_stacks():
    """A span that closes in one thread while another thread's span is
    open is no child of it."""
    opened, closed = threading.Event(), threading.Event()

    def other():
        opened.wait(timeout=30)
        with span("t.b"):
            time.sleep(0.005)
        closed.set()

    t = threading.Thread(target=other)
    t.start()
    with span("t.a"):
        opened.set()
        assert closed.wait(timeout=30)
    t.join(timeout=30)
    assert not t.is_alive()
    tot = trace.totals()
    assert tot["t.b"]["count"] == 1 and tot["t.b"]["total_ns"] >= 5_000_000
    assert tot["t.a"]["self_ns"] == tot["t.a"]["total_ns"]


def test_span_opens_a_profiler_range_of_its_duration():
    """The range holds the span's clock: they differ by the range's own
    entry and exit (the first range of a process also loads the
    profiler's operators, so one is opened first)."""
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        with span("t.first"):
            pass
        with span("t.ranged"):
            time.sleep(0.01)
    ranges = [(s, e) for name, s, e in _events(prof) if name == "t.ranged"]
    assert len(ranges) == 1
    dur = ranges[0][1] - ranges[0][0]
    assert abs(dur - trace.totals()["t.ranged"]["total_ns"]) < 1_000_000
    with span("t.unranged"):          # no profiler: counted, no range
        pass
    assert trace.totals()["t.unranged"]["count"] == 1


def test_stage_line_reads_the_spans_since_a_copy():
    """The operator's line: ms per dispatch of each stage, the drain's wait
    and the whole run, counted from the copy taken before the run."""
    with span("e.dispatch"):
        pass
    since = trace.totals()
    with span("e.run"):
        for _ in range(4):
            with span("e.dispatch"):
                time.sleep(0.001)
            with span("e.drain_wait"):
                time.sleep(0.002)
    line = trace.stage_line("e", ("dispatch", "decode"), since)
    got = re.fullmatch(r"host ms per dispatch \(4 dispatches\): dispatch ([\d.]+), "
                       r"decode 0\.000; drain wait ([\d.]+); run ([\d.]+)", line)
    assert got, line
    dispatch, wait, run = map(float, got.groups())
    assert 1.0 <= dispatch and 2.0 <= wait and dispatch + wait <= run


def test_reset_clears_the_table():
    with span("t.x"):
        pass
    copy = trace.totals()
    copy["t.x"]["count"] = 99            # a copy: the table is unchanged
    assert trace.totals()["t.x"]["count"] == 1
    trace.reset()
    assert trace.totals() == {}


def test_bsgs_engine_counts_its_stages(table, tmp_path):
    eng = _engine(table, [5000, 12345, 777], tmp_path)
    eng.run()
    tot = trace.totals()
    assert tot["bsgs.dispatch"]["count"] == eng.dispatches > 0
    assert tot["bsgs.seed"]["count"] >= 1
    assert tot["bsgs.run"]["count"] == 1
    for step in ("giant_scan", "to_affine", "probe", "topk"):
        assert tot[f"bsgs.{step}"]["count"] == eng.dispatches
    wait = tot.get("bsgs.drain_wait", {}).get("total_ns", 0)
    assert wait <= tot["bsgs.run"]["total_ns"]
    assert tot["bsgs.decode"]["count"] == eng.dispatches


def test_bsgs_dropout_is_a_span(table, tmp_path):
    eng = _engine(table, [600, 12000, 15000], tmp_path, lanes=2, steps=1)
    eng.run()
    assert eng.cfg.lanes > 2
    assert trace.totals()["bsgs.dropout"]["count"] >= 1


def test_cpu_dispatch_trace_keeps_the_step_names(table, tmp_path):
    """The step's spans keep their names and sit inside bsgs.dispatch."""
    eng = _engine(table, [5000], tmp_path)
    state = eng._seed(eng.start + table.m)
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        eng._dispatch(state)
    ev = {name: (s, e) for name, s, e in _events(prof) if name.startswith("bsgs.")}
    assert set(ev) == {"bsgs.dispatch", "bsgs.giant_scan", "bsgs.to_affine",
                       "bsgs.probe", "bsgs.topk"}
    d0, d1 = ev["bsgs.dispatch"]
    assert d0 <= ev["bsgs.probe"][0] <= ev["bsgs.probe"][1] <= d1


@pytest.mark.parametrize("fmt,hashed", [("npz", 1), ("d", 3)])
def test_table_save_and_load_count_each_checksum(table, tmp_path, fmt, hashed):
    path = str(tmp_path / f"t.{fmt}")
    bsgs.save_table(table, path=path)
    assert trace.totals()["table.checksum"]["count"] == hashed
    assert trace.totals()["table.save"]["count"] == 1
    trace.reset()
    tbl = bsgs.load_table(M, path=path)
    tot = trace.totals()
    assert tot["table.checksum"]["count"] == hashed and tot["table.load"]["count"] == 1
    assert tot["table.checksum"]["total_ns"] <= tot["table.load"]["total_ns"]
    trace.reset()
    tbl.device_packed(torch.device("cpu"))
    tbl.device_packed(torch.device("cpu"))          # cached: no second span
    tot = trace.totals()
    assert tot["table.pack"]["count"] == tot["table.upload"]["count"] == 1
    # the .d format writes the packed sidecar (slab, starts) on its first pack
    assert tot.get("table.checksum", {}).get("count", 0) == (2 if fmt == "d" else 0)


def test_table_build_is_a_span():
    bsgs.build_baby_table(64, pivots=2, width=16, steps=2, device="cpu")
    assert trace.totals()["table.build"]["count"] == 1


def test_walker_engine_spans(tmp_path):
    keys = [0x1005, 0x1400]
    tgt = tmp_path / "h160.txt"
    tgt.write_text("".join(hash160(ecc.compress(ecc.pubkey(k))).hex() + "\n" for k in keys))
    ts = load_hash160_file(str(tgt), is_address=False)
    eng = Engine(WalkerConfig(pivots=4, width=64, steps=2, mode="compressed"), ts,
                 0x1000, 0x1600, sink=ResultSink(path=str(tmp_path / "f.txt"), quiet=True),
                 quiet=True, device="cpu")
    eng.run()
    assert sorted(eng.found_keys) == keys
    tot = trace.totals()
    assert tot["walker.run"]["count"] == tot["walker.seed"]["count"] == 1
    n = tot["walker.dispatch"]["count"]
    assert n >= 1 and tot["walker.decode"]["count"] == n
    assert tot["walker.dispatch"]["self_ns"] < tot["walker.dispatch"]["total_ns"]


def test_daemon_query_spans_nest(table, tmp_path):
    srv = server.BsgsdServer(table, port=0, lanes=4, steps=2,
                             result_path=str(tmp_path / "found.txt"), device="cpu")
    assert srv.search(ecc.compress(ecc.pubkey(7777)).hex(), 1, 16384) == 7777
    assert srv.search(ecc.compress(ecc.pubkey(7777)).hex(), 1, 512) is None
    tot = trace.totals()
    assert tot["bsgsd.query"]["count"] == tot["bsgsd.engine_init"]["count"] == 2
    assert tot["bsgs.run"]["count"] == 2
    nested = tot["bsgsd.engine_init"]["total_ns"] + tot["bsgs.run"]["total_ns"]
    assert tot["bsgsd.query"]["self_ns"] == tot["bsgsd.query"]["total_ns"] - nested


@pytest.mark.parametrize("mode", ["bsgs", "walker"])
def test_cli_prints_the_operator_line(tmp_path, monkeypatch, capsys, mode):
    monkeypatch.chdir(tmp_path)
    if mode == "bsgs":
        (tmp_path / "t.txt").write_text("04%064x%064x\n" % ecc.pubkey(0x3a7e9))
        argv = ["-m", "bsgs", "-r", "1:80000", "-n", "0x100000", "-k", "1"]
    else:
        from keyhunt_tpu_torch.io.base58 import p2pkh_address
        (tmp_path / "t.txt").write_text(
            p2pkh_address(hash160(ecc.compress(ecc.pubkey(0x1005)))) + "\n")
        argv = ["-m", "address", "-r", "1000:1600", "--pivots", "4", "--width",
                "64", "--steps", "2"]
    assert cli.main(argv + ["-f", "t.txt", "--device", "cpu"]) == 0
    out = capsys.readouterr().out
    stages = "seed, dispatch, fetch, decode, rerun" + (", dropout" if mode == "bsgs" else "")
    line = re.search(rf"\[\+\] {'BSGS' if mode == 'bsgs' else 'walker'} host ms per "
                     rf"dispatch \((\d+) dispatches\): (.*); drain wait ([\d.]+); run ([\d.]+)$",
                     out, re.M)
    assert line, out
    assert int(line.group(1)) == trace.totals()[f"{mode}.dispatch"]["count"]
    assert [p.split()[0] for p in line.group(2).split(", ")] == stages.split(", ")
    assert float(line.group(4)) >= float(line.group(3))
    if mode == "bsgs":       # the summary line the chip smoke parses is unchanged
        assert re.search(r"^\[\+\] BSGS: \d+ dispatches, \d+ giant points in ", out, re.M)


def _ctx(device_events=10, gaps=()):
    return {"trace": {"window_s": 2.0, "busy_s": 1.9, "device_events": device_events,
                      "idle_gaps": [list(g) for g in gaps], "stage_s": {}}}


def test_engine_idle_share_reader():
    read = harness.load_reader("engine_idle_share.bsgs")
    gaps = [("host", 0.01), ("bsgs.to_affine", 0.02), ("bsgs.dispatch", 0.006),
            ("bsgs.drain_wait", 0.003), ("bsgs.seed", 0.001)]
    assert read(_ctx(gaps=gaps)) == pytest.approx(100 * 0.007 / 2.0)
    # the host waiting on the device is not the engine's work
    assert read(_ctx(gaps=[("host", 0.05), ("bsgs.drain_wait", 0.03)])) == 0.0
    assert read(_ctx(device_events=0, gaps=gaps)) is None
    assert read({}) is None


@pytest.mark.parametrize("metric,spans", [
    ("engine_host_ms.bsgs", ("bsgs.run", "bsgs.dispatch", "bsgs.drain_wait", "bsgs.decode")),
    ("table_checksum_s", ("table.checksum",)),
    ("table_upload_s", ("table.upload",))])
def test_program_span_readers(metric, spans):
    read = harness.load_reader(metric)
    assert read(_ctx()) is None              # fresh totals: no span yet
    with span(spans[0]):                     # a run, or one checksum or upload
        for _ in range(3):
            for name in spans[1:]:           # its dispatches, waits, decodes
                with span(name):
                    time.sleep(0.001)
        time.sleep(0.002)                    # the run's own lines: not counted
    tot = trace.totals()
    if metric == "engine_host_ms.bsgs":
        want = (tot["bsgs.dispatch"]["total_ns"] + tot["bsgs.decode"]["total_ns"]) / 3 / 1e6
    else:
        want = tot[spans[0]]["total_ns"] / 1e9
    assert read(_ctx()) == pytest.approx(want) and want > 0
    assert read(_ctx(device_events=0)) is None and read({}) is None


@pytest.mark.parametrize("metric", ["engine_idle_share.bsgs", "engine_host_ms.bsgs",
                                    "table_checksum_s", "table_upload_s"])
def test_readers_leave_out_a_program_without_spans(metric, monkeypatch):
    """The benchmark's readers also run over checkouts of the program from
    before its span table: there each returns None rather than raise."""
    with span("bsgs.dispatch"), span("table.checksum"), span("table.upload"):
        pass
    ctx = _ctx(gaps=[("bsgs.dispatch", 0.01), ("bsgs.seed", 0.002)])
    read = harness.load_reader(metric)
    assert read(ctx) is not None
    monkeypatch.delattr(trace, "totals")
    assert read(ctx) is None
