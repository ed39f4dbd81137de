"""The port's benchmark harness, the twin of the repository's ``benchmarks/``
(which imports the JAX package, so the port may not). So far the paper-figure
family: ``python -m repro_torch.bench.run --only paper_figures --out DIR``."""
