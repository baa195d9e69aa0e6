"""The frozen yardstick and the counting rules: roofline and idle
arithmetic on a synthetic event list, kernel costs, keys counted."""

import pytest

from benchmark import yardstick as ys


def test_costs_and_bounds():
    # K4 at BSGS's 131072 lanes x 16 steps: operations bound, 0.1634 ms
    nbytes, ops = ys.cost("giant_scan", (131072, 16))
    assert ops == 16 * 131072 * (8 * 232 + 3 * 170 + 10 * 24)
    assert ys.bound_s(nbytes, ops) == pytest.approx(0.1634e-3, rel=2e-3)
    # K3 at 2^21: 0.0436 ms; K5 at 2^18: 0.0359 ms; K1 at 2^21, bytes: 0.0601 ms
    assert ys.bound_s(*ys.cost("batch_inv", 1 << 21)) == pytest.approx(0.0436e-3, rel=2e-3)
    assert ys.bound_s(*ys.cost("hash160_both", 1 << 18)) == pytest.approx(0.0359e-3, rel=3e-3)
    assert ys.bound_s(*ys.cost("field_mul", 1 << 21)) == pytest.approx(0.0601e-3, rel=2e-3)
    assert ys.FEWEST["hash160_both"] == 4586


def test_kernel_names():
    assert ys.kernel_id("giant_scan_kernel(unsigned int const*, ...)") == "K4"
    assert ys.kernel_id("(anonymous namespace)::giant_scan_kernel(unsigned int const*, unsig") == "K4"
    assert ys.kernel_id("void (anonymous namespace)::hash160_both_kernel<true>(unsigned") == "K5"
    assert ys.kernel_id("binv_down_kernel") == ys.kernel_id("binv_up_kernel") == "K3"
    assert ys.kernel_id("hash160_uncompressed_kernel") == "K6"
    assert ys.kernel_id("void at::native::index_elementwise_kernel") is None


def synthetic():
    """Two dispatches in a 10 ms window: a span per stage on the host, and
    device events tied to their launches by correlation id."""
    ms = 10**6
    cpu = [(0, 4 * ms, "bsgs.giant_scan", 0), (int(0.5 * ms), int(0.6 * ms), "cudaLaunchKernel", 1),
           (4 * ms, 9 * ms, "bsgs.probe", 0), (int(4.2 * ms), int(4.3 * ms), "cudaLaunchKernel", 2),
           (int(4.4 * ms), int(4.5 * ms), "cuLaunchKernel", 3),
           (int(9.5 * ms), int(9.6 * ms), "cudaLaunchKernel", 4)]
    dev = [(1 * ms, 3 * ms, "giant_scan_kernel", 1),            # 2 ms, K4
           (5 * ms, 6 * ms, "index_kernel", 2),                  # 1 ms in probe
           (int(5.5 * ms), 7 * ms, "binv_up_kernel", 3),         # overlaps: union 2 ms
           (int(9.8 * ms), 11 * ms, "giant_scan_kernel", 4),     # clipped to 0.2 ms
           (0, 4 * ms, "bsgs.giant_scan", 0)]                    # an annotation
    return cpu, dev, (0, 10 * ms)


def test_reduce_trace():
    cpu, dev, window = synthetic()
    t = ys.reduce_trace(cpu, dev, "bsgs", window)
    assert t["window_s"] == pytest.approx(0.010)
    assert t["busy_s"] == pytest.approx(0.0042)                  # 2 + 2 + 0.2 ms
    assert t["device_events"] == 4
    assert t["stage_s"] == pytest.approx({"bsgs.giant_scan": 0.002, "bsgs.probe": 0.0025})
    assert t["kernel_s"] == pytest.approx({"K4": 0.0022, "K3": 0.0015})
    gaps = dict(t["idle_gaps"])
    # idle 0-1 and 3-4 under giant_scan's span, 4-5 and 7-9 under probe's,
    # 9-9.5 and 9.6-9.8 on the host outside every span, 9.5-9.6 in the
    # launch call (not a span of the prefix)
    assert gaps == pytest.approx({"bsgs.giant_scan": 0.002, "bsgs.probe": 0.003,
                                  "host": 0.0008})
    ctx = {"trace": t, "ticks": 2,
           "launch_widths": {("giant_scan", (131072, 16)): 2, ("field_mul", 64): 5}}
    assert ys.idle_pct(ctx) == pytest.approx(58.0)
    assert ys.stage_ms_per_tick(ctx, "bsgs.probe") == pytest.approx(1.25)
    k4 = 2 * ys.bound_s(*ys.cost("giant_scan", (131072, 16))) / 0.0022
    assert ys.roofline(ctx, "K4") == pytest.approx(100 * k4)
    assert ys.roofline(ctx, "K3") is None          # no K3 launch counted
    assert ys.roofline(ctx, "K5") is None


def test_counting_rules():
    """keys/s counts as the reference does: a BSGS giant point covers 2m
    keys (keyhunt.cpp:2871-2874); a walker point 2 keys compressed, 6
    with -e (keyhunt.cpp:2883-2891)."""
    from keyhunt_tpu_torch.search.bsgs import BsgsConfig, auto_lanes
    from keyhunt_tpu_torch.search.walker import WalkerConfig
    from benchmark import harness
    cfg = harness.load_json(harness.ROOT + "/benchmark/configs/bsgs-m2e28.json")
    m, S = cfg["m"], cfg["steps"]
    assert m == cfg["k"] * 2 ** (cfg["n"].bit_length() // 2)
    b = BsgsConfig(m=m, lanes=cfg["lanes_total"] // 16, steps=S)
    assert b.keys_per_call(16) == 16 * b.lanes * S * 2 * m
    # the CLI sizes 16 targets over a 2^64 window as drivers/bsgs_sweep.py does
    assert auto_lanes(m, S, 1 << 63, (1 << 64) + (1 << 63), n_targets=16) == b.lanes
    w = harness.load_json(harness.ROOT + "/benchmark/configs/walker-h160-compressed.json")
    geo = {k: w[k] for k in ("pivots", "width", "steps")}
    assert WalkerConfig(**geo, mode="compressed").keys_per_point == 2
    assert WalkerConfig(**geo, mode="compressed", endo=True).keys_per_point == 6
    assert WalkerConfig(**geo).keys_per_call == 1 << 22
