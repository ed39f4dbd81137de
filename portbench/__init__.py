"""The port's benchmark: one harness that reads its cells, configurations,
traffic mixes and per-layer metrics as files (see README.md)."""
