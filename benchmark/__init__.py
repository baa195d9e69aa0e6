"""The benchmark of keyhunt_tpu_torch: one command runs one cell once.

See BENCHMARK.json at the repository root and PERF.md. Nothing in this
folder imports `jax`, `jaxlib`, `flax` or the JAX package `keyhunt_tpu`;
the reference (`benchmark.reference`) imports nothing of the port either.
"""
