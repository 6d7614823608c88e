"""Scene builders of the JAX package's benchmarks (`nbx/bench/`), for the
port. The timing harnesses are not ported yet (ROADMAP.md Queue 1)."""
