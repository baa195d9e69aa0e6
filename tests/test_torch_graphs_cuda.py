"""The one-device BSGS step's CUDA graphs (`search.bsgs.GiantStep`,
`graphs.StageGraphs`) on a CUDA GPU:

- over six dispatches at one shape (a re-seed after the fourth) and four
  at another, the replayed step gives the eager step's lanes and payload
  bit for bit, and every call counts the launches an eager call counts;
- a one-dispatch engine, the daemon's query, captures nothing.

Every test here needs a card and skips without one (marker `cuda`). On a
machine with a card, with no JAX installed:

    python -m pytest -p no:cacheprovider --noconftest -m cuda tests/test_torch_graphs_cuda.py
"""

import collections

import pytest
import torch

from keyhunt_tpu_torch import _build, server
from keyhunt_tpu_torch.ops import u256
from keyhunt_tpu_torch.ref import ecc
from keyhunt_tpu_torch.search import bsgs

pytestmark = pytest.mark.cuda

M = 1 << 12


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA GPU: CUDA graphs capture on the card only")
    return torch.device("cuda", 0)


@pytest.fixture
def table(cuda):
    return bsgs.build_baby_table(M, pivots=2, width=32, steps=2, device=cuda)


def _lanes(cfg, keys, c0, device):
    px, py = bsgs.seed_lanes(cfg, [ecc.pubkey(k) for k in keys], c0)
    X, Y = u256.to_torch(px, device), u256.to_torch(py, device)
    Z = torch.zeros_like(X)
    Z[0] = 1
    return X, Y, Z


def _run(step, cfg, keys, c0s, device):
    """Each call's outputs (copied to the host) and the launches it counted
    by (kernel, width); c0 None goes on from the last call's lanes."""
    out, state = [], None
    for c0 in c0s:
        if c0 is not None:
            state = _lanes(cfg, keys, c0, device)
        before = collections.Counter(_build.LAUNCH_WIDTHS)
        *state, payload = step(*state)
        launches = collections.Counter(_build.LAUNCH_WIDTHS)
        launches.subtract(before)
        out.append(([t.cpu() for t in (*state, payload)], +launches))
    return out


def test_replayed_step_equals_eager(cuda, table):
    res = table.resident([cuda])
    keys = [3 * M + 77, 40 * M + 5, 200 * M + 9, 9 * M + 1]
    shapes = ((keys[:2], 64, [1 + M, None, None, None, 1 + 801 * M, None]),
              (keys, 32, [1 + M, None, None, None]))
    runs = {}
    for capture in (False, True):
        runs[capture] = []
        for targets, lanes, c0s in shapes:
            cfg = bsgs.BsgsConfig(m=M, lanes=lanes, steps=4)
            step = bsgs.make_giant_step_fn(cfg, res, capture=capture)
            runs[capture] += _run(step, cfg, targets, c0s, cuda)
            assert step.counts.captures == (1 if capture else 0)
            assert step.counts.replays == (len(c0s) - 2 if capture else 0)
    assert len(runs[True]) == 10
    K = bsgs.BsgsConfig(m=M).max_hits
    assert any(int(outs[-1][2 * K]) > 0 for outs, _ in runs[False])
    for (got, got_launches), (want, want_launches) in zip(runs[True], runs[False]):
        for g, w in zip(got, want):
            assert torch.equal(g, w)
        assert got_launches == want_launches
        assert sum(n for (k, _), n in got_launches.items() if k == "probe_packed") == 1
        assert sum(n for (k, _), n in got_launches.items() if k == "giant_scan") == 1


def test_one_dispatch_query_captures_nothing(cuda, table, tmp_path, monkeypatch):
    """The daemon's query: one engine, one dispatch, no capture."""
    engines = []

    class Recorded(bsgs.BsgsEngine):
        def run(self, *args, **kw):
            engines.append(self)
            return super().run(*args, **kw)
    monkeypatch.setattr(server, "BsgsEngine", Recorded)
    srv = server.BsgsdServer(table, port=0, device=cuda,
                             result_path=str(tmp_path / "found.txt"))
    key = 123456 * M + 321
    pub = ecc.compress(ecc.pubkey(key)).hex()
    assert srv.search(pub, 1, 1 << 30) == key
    (eng,) = engines
    assert eng.dispatches == 1
    assert (eng.graph_captures, eng.graph_replays) == (0, 0)
