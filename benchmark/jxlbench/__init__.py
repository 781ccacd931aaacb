"""The port's benchmark harness (see benchmark/run.py and BENCHMARK.json):
inputs from a seed, the load generator, the window's metrics, the traced
run's per-layer readings, and the check against a frozen golden model
(reference/), which imports nothing of the program."""
