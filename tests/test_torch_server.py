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
    cache = srv.tbl.__dict__["_dev_packed"]
    slab = cache[torch.device("cpu")][0]
    pclient.BsgsdClient("127.0.0.1", srv.port, timeout=300).query(_pub(KEY), 1, 4096)
    assert list(cache) == [torch.device("cpu")] and cache[torch.device("cpu")][0] is slab


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
def test_main_multi_device_not_ported(argv):
    with pytest.raises(SystemExit, match="not yet ported"):
        server.main(argv + ["--device", "cpu"])


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
