"""Generators of the benchmark's traffic mixes, one module per kind. Each
`run(cell)` makes its inputs from the seed, sets the program up, drives
it through the window, and checks what it answered against the plain
reference (`benchmark.reference`)."""
