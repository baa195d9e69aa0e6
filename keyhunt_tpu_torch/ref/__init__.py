"""Host-side pure-Python reference implementations (the port's copy of
keyhunt_tpu/ref, under the same module names).

Used for (a) one-time setup work that is O(tables), not O(keys) — generator
tables, pivot seeding — and (b) exact verification of the rare candidate
hits surfaced by the device kernels (mirrors the recompute-verify step at
`keyhunt.cpp:5216-5229` / `keyhunt.cpp:3629-3634`), and (c) test oracles.
"""
