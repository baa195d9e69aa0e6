"""Host-side I/O: target parsing, base58, result sinks (the port's copy of
keyhunt_tpu/io, under the same module names)."""
