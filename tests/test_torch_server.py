"""The port's bsgsd daemon (keyhunt_tpu_torch.server) on the CPU, driven by
the reference's own client (keyhunt_tpu.client, unchanged) and by the
port's copy of it: raw-line and HTTP queries answered with the key, 404
outside the range, 400 for malformed requests; and `python -m
keyhunt_tpu_torch.server --device cpu` answering a query."""

import os
import pathlib
import socket
import subprocess
import sys
import threading

import pytest
import torch

from keyhunt_tpu import client as jclient
from keyhunt_tpu_torch import client as pclient
from keyhunt_tpu_torch import server
from keyhunt_tpu_torch.ref import ecc
from keyhunt_tpu_torch.search import bsgs

ROOT = pathlib.Path(__file__).resolve().parent.parent
KEY = 7777
CLIENTS = {"jax": jclient.BsgsdClient, "port": pclient.BsgsdClient}


@pytest.fixture(scope="module")
def srv(tmp_path_factory):
    tbl = bsgs.build_baby_table(256, pivots=2, width=32, steps=2, device="cpu")
    tmp = tmp_path_factory.mktemp("srv")
    s = server.BsgsdServer(tbl, port=0, lanes=4, steps=2,
                           result_path=str(tmp / "found.txt"), device="cpu")
    s.start()
    yield s
    s.stop()


def _pub(k: int) -> str:
    return ecc.compress(ecc.pubkey(k)).hex()


@pytest.mark.parametrize("http", [False, True], ids=["raw", "http"])
@pytest.mark.parametrize("client", sorted(CLIENTS))
def test_query_found_and_not_found(srv, client, http):
    cli = CLIENTS[client]("127.0.0.1", srv.port, timeout=300, http=http)
    assert cli.query(_pub(KEY), 1, 16384) == f"{KEY:064x}"
    assert cli.query(_pub(KEY), 0x10000, 0x20000) is None      # outside the range
    assert cli.query(_pub(1 << 60), 1, 16384) is None


@pytest.mark.parametrize("request_bytes", [
    b"garbage\n",
    b"02" + b"ab" * 32 + b" zz:yy\n",
    b"POST /search HTTP/1.1\r\nContent-Length: 9\r\n\r\nnot json!",
    b'POST /search HTTP/1.1\r\nContent-Length: 15\r\n\r\n{"pubkey": "1"}',
], ids=["raw_garbage", "raw_bad_range", "http_bad_json", "http_missing_keys"])
def test_bad_requests_get_400(srv, request_bytes):
    with socket.create_connection(("127.0.0.1", srv.port), timeout=30) as s:
        s.sendall(request_bytes)
        reply = s.recv(4096)
    want = b"HTTP/1.1 400" if request_bytes.startswith(b"POST") else b"400 Bad Request"
    assert reply.startswith(want)


def test_http_headers(srv):
    body = ('{"pubkey": "%s", "from": "1", "to": "4000"}' % _pub(KEY)).encode()
    req = (b"POST /search HTTP/1.1\r\nHost: x\r\nContent-Type: application/json\r\n"
           + f"Content-Length: {len(body)}\r\n\r\n".encode() + body)
    with socket.create_connection(("127.0.0.1", srv.port), timeout=300) as s:
        s.sendall(req)
        resp = jclient.BsgsdClient._read_all(s)
    head, _, payload = resp.partition(b"\r\n\r\n")
    assert head.startswith(b"HTTP/1.1 200 OK")
    assert b"X-Elapsed-Seconds:" in head
    assert payload.decode().strip() == f"{KEY:064x}"


def test_engines_share_one_slab_upload(srv):
    """Every request's engine binds the table's cached slab: one upload."""
    pclient.BsgsdClient("127.0.0.1", srv.port, timeout=300).query(_pub(KEY), 1, 4096)
    cache = srv.tbl._resident
    key = ((torch.device("cpu"),), 0, 1)
    slab = cache[key].slabs[0]
    pclient.BsgsdClient("127.0.0.1", srv.port, timeout=300).query(_pub(KEY), 1, 4096)
    assert list(cache) == [key] and cache[key].slabs[0] is slab


def test_client_helpers_match_jax(srv, tmp_path):
    for args in [(1, 100, 7), (5, 5, 1), (0x10, 0x1000, 0x100)]:
        assert [(c.index, c.k_from, c.k_to) for c in pclient.chunk_range(*args)] == \
            [(c.index, c.k_from, c.k_to) for c in jclient.chunk_range(*args)]
    res = pclient.scan_for_pubkey(_pub(KEY), 1, 16383, [("127.0.0.1", srv.port)],
                                  chunk_size=4096, timeout=300,
                                  matches_csv=str(tmp_path / "m.csv"), failed_log=None)
    assert res.found == {_pub(KEY): f"{KEY:064x}"} and not res.failed_chunks
    assert (tmp_path / "m.csv").read_text().startswith(_pub(KEY))


@pytest.mark.parametrize("argv", [["--devices", "2"], ["--coordinator", "h:1"]])
def test_main_multi_device_not_ported(argv, monkeypatch):
    """The multi-device flags reach the daemon: `--devices 2` shards each
    query's engine across 2 CPU shards (the daemon is built and queried
    in-process in place of serving), and `--coordinator` without the
    process counts exits with a clear error."""
    if "--coordinator" in argv:
        with pytest.raises(SystemExit, match="needs --num-processes"):
            server.main(argv + ["--device", "cpu"])
        return
    built = []
    monkeypatch.setattr(server.BsgsdServer, "serve_forever",
                        lambda self: built.append(self))
    assert server.main(argv + ["--device", "cpu", "-n", "0x100000", "-k", "1",
                               "--lanes", "4", "--steps", "2"]) == 0
    (srv,) = built
    srv.result_path = os.devnull
    assert srv.devices == 2 and srv.search(_pub(KEY), 1, 16384) == KEY


def test_main_on_the_cpu_answers_a_query(tmp_path):
    """`python -m keyhunt_tpu_torch.server --device cpu` (m = 1024) on an
    ephemeral port: a raw-line query for a planted key gets the key."""
    env = {**os.environ, "PYTHONPATH": str(ROOT)}
    proc = subprocess.Popen(
        [sys.executable, "-m", "keyhunt_tpu_torch.server", "--device", "cpu",
         "-p", "0", "-n", "0x100000", "-k", "1", "--lanes", "4", "--steps", "2"],
        cwd=tmp_path, env=env, stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
        text=True)
    timer = threading.Timer(240, proc.kill)
    timer.start()
    try:
        lines = []
        for line in proc.stdout:
            lines.append(line)
            if "listening on" in line:
                break
        assert "listening on" in lines[-1], "".join(lines)
        port = int(lines[-1].rsplit(":", 1)[1])
        cli = pclient.BsgsdClient("127.0.0.1", port, timeout=200)
        assert cli.query(_pub(KEY), 1, 16384) == f"{KEY:064x}"
    finally:
        timer.cancel()
        proc.kill()
        proc.wait()


def test_bad_range_is_refused_before_it_is_published(srv, monkeypatch):
    """A query the engine would refuse raises before process 0 hands it to
    the other processes of a multi-process daemon."""
    published = []
    monkeypatch.setattr(srv, "_publish", published.append)
    for k_from, k_to in ((5, 1), (0, 16384), (7, 7)):
        with pytest.raises(ValueError, match="bad range"):
            srv.search(_pub(KEY), k_from, k_to)
    assert published == []


class _Store:
    """The published queries, as a follower reads them from the store."""

    def __init__(self, queries):
        self.queries = {f"keyhunt:bsgsd:{i}": q.encode()
                        for i, q in enumerate(queries)}

    def get(self, key):
        return self.queries[key]


def test_follow_survives_a_failing_query(srv, monkeypatch, tmp_path):
    """A follower goes on past queries that fail (process 0 answers them
    400) and runs the next one: all processes stay on one query
    sequence."""
    from types import SimpleNamespace
    from keyhunt_tpu_torch import runtime
    queries = [f"{_pub(KEY)} 5 1", f"zz 1 {KEY + 100}",
               f"{_pub(KEY)} 1 {KEY + 100}", "stop"]
    monkeypatch.setattr(runtime, "current",
                        lambda: SimpleNamespace(store=_Store(queries),
                                                rank=1, world=1))
    follower = server.BsgsdServer(srv.tbl, port=0, lanes=4, steps=2,
                                  result_path=str(tmp_path / "found.txt"),
                                  device="cpu")
    got = []
    search = follower._search
    monkeypatch.setattr(follower, "_search",
                        lambda *a: got.append(search(*a)) or got[-1])
    follower.follow()
    assert got == [KEY] and follower._queries == len(queries)


def test_mesh_engines_share_one_shard_upload(tmp_path):
    """On a mesh, every request's engine binds the table's cached shards:
    one upload for the daemon's life, as on one device."""
    tbl = bsgs.build_baby_table(256, device="cpu")
    s = server.BsgsdServer(tbl, port=0, lanes=4, steps=2, device="cpu",
                           devices=2, result_path=str(tmp_path / "found.txt"))
    assert s.search(_pub(KEY), 1, 16384) == KEY
    (shards,) = tbl._resident.values()
    assert len(shards.slabs) == 2
    assert s.search(_pub(KEY), 1, 8192) == KEY
    assert list(tbl._resident.values()) == [shards]
