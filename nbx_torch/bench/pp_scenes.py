"""The small scenes of the P3M pair-pass checks, those of the JAX package's
tests/test_ppkernel.py: the port's CPU tests hold each pass on them against
the JAX package, and the card's checks (tests/test_torch_cuda.py,
chip_smoke.py) hold the kernels K4 and K5 against their plain versions.
Numpy, from fixed seeds."""

from __future__ import annotations

import numpy as np

MAIN_CASES = {
    "overflowing": "700 bodies overflowing, g=6 K=12",
    "bucketed": "900 bodies, field + core, census buckets",
    "bucket_drop": "400 bodies, undersized last bucket",
    "k80": "2200 bodies, K=80",
    "k200": "1200 bodies, K=200 (two work items per cell)",
    "erfc": "64 bodies, a >> scene (erfc -> 1)",
}
RESIDUAL_CASES = {
    "core": "1500 bodies, core overflowing K=16",
    "affected_cap": "4000 bodies, K=4, affected_cap=64",
}


def uniform(n: int, seed: int, lo: float, hi: float):
    """(pos [n, 3], mass [n]) float32, uniform in [lo, hi)^3, masses in [0.5, 2)."""
    rng = np.random.default_rng(seed)
    return (rng.uniform(lo, hi, (n, 3)).astype(np.float32),
            rng.uniform(0.5, 2.0, n).astype(np.float32))


def clustered(seed: int = 7, n_field: int = 600, n_core: int = 300, sigma: float = 1.5):
    """A uniform field over [1, 49)^3 and a Gaussian core at its centre."""
    rng = np.random.default_rng(seed)
    field = rng.uniform(1.0, 49.0, (n_field, 3))
    core = np.clip(rng.normal(25.0, sigma, (n_core, 3)), 1.0, 49.0)
    pos = np.concatenate([field, core]).astype(np.float32)
    return pos, rng.uniform(0.5, 2.0, pos.shape[0]).astype(np.float32)


def main_case(name: str):
    """(pos, mass, G, a, box, g, K, eps, buckets) of a main-pass scene;
    buckets None (uniform layout), a tuple, or "census" (size them with
    pp_buckets_for)."""
    if name == "overflowing":
        return (*uniform(700, 3, 1.0, 24.0), 0.7, 50.0 / 6 / 3.0, 50.0, 6, 12, 0.05, None)
    if name == "bucketed":
        return (*clustered(), 0.7, 50.0 / 6 / 3.0, 50.0, 6, 64, 0.05, "census")
    if name == "bucket_drop":
        return (*uniform(400, 11, 1.0, 49.0), 0.7, 50.0 / 4 / 3.0, 50.0, 4, 16, 0.05,
                ((8, 8, 8), (16, 16, 8)))
    if name == "k80":
        return (*uniform(2200, 7, 1.0, 49.0), 0.7, 50.0 / 4 / 3.0, 50.0, 4, 80, 0.05, None)
    if name == "k200":  # more kept bodies in a cell than one work item's 128 targets
        return (*uniform(1200, 11, 1.0, 29.0), 0.7, 30.0 / 3 / 3.0, 30.0, 3, 200, 0.05, None)
    if name == "erfc":  # a >> the scene, erfc -> 1
        rng = np.random.default_rng(2)
        pos = (5.0 + rng.uniform(0, 1.5, (64, 3))).astype(np.float32)
        return pos, rng.uniform(0.5, 2.0, 64).astype(np.float32), 1.0, 1e3, 100.0, 4, 64, 0.2, None
    raise KeyError(name)


def residual_case(name: str):
    """(pos, mass, G, a, box, g, K, max_residual, affected_cap, eps) of a
    residual-pass scene: "core" overflows a few cells, "affected_cap" has
    more affected cells than its cap, so n_missed > 0."""
    if name == "core":
        rng = np.random.default_rng(9)
        core = rng.normal(25.0, 1.2, (600, 3))
        field = rng.uniform(1.0, 49.0, (900, 3))
        pos = np.clip(np.concatenate([core, field]), 1.0, 49.0).astype(np.float32)
        return (pos, rng.uniform(0.5, 2.0, 1500).astype(np.float32), 0.8, 50.0 / 6 / 3.0, 50.0, 6, 16,
                512, 256, 0.05)
    if name == "affected_cap":
        return (*uniform(4000, 4, 1.0, 49.0), 1.0, 50.0 / 8 / 3.0, 50.0, 8, 4, 1024, 64, 0.05)
    raise KeyError(name)
