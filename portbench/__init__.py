"""The port's benchmark: one cell a run, found by name from BENCHMARK.json
(README.md in this directory says how to run and extend it)."""
