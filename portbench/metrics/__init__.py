"""One module a per-layer metric, named as the metric in BENCHMARK.json:
`read(trace)` -> the number, or None where the trace holds nothing for
it (the harness then leaves the metric out of the line)."""
