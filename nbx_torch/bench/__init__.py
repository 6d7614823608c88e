"""The port's benchmarks and the scene builders of the JAX package's
(`nbx/bench/`): the gravity-only harnesses `drift`, `latency` and
`throughput`, the collision-layout harnesses `granular` and `collsplit`, and
the scenes of `p3m_cluster` and `pp_scenes`. The other harnesses of
`nbx/bench/` are not ported yet (ROADMAP.md Queue 1).
"""
