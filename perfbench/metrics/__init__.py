"""Metric readers, one a file, found by the metric's name. Each has
`read(record) -> float | None` (None: nothing to read, and the harness
leaves the metric out) and, where it reads the trace, `RANGES`: the port
functions, (module under the port's package, attribute), that the traced
window wraps in ranges."""
