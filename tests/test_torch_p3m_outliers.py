"""The two-level P3M residual against `nbx` on the CPU: tests/test_p3m.py's
scene of a core with two satellite clumps and a field, cut to half its
8,192 bodies (mesh 32 for its 64, submesh 36 / 12 / 48 for its 64 / 16 /
128). The clumps lie outside the submesh (the median +- 6 interquartile
half-widths) and take the exact outlier block. Held to `nbx` at
tests/test_torch_p3m.py's bar (rtol 2e-5, atol 3e-6 max|acc|) with
n_uncorrected exact (0), and to the direct sum as tests/test_p3m.py holds
`nbx`: in the core and in the clumps, the two-level median error within
1.5x the dense one plus 1e-3."""

import numpy as np
import torch

from test_torch_p3m_twolevel import SUBMESH, _errors

torch.set_num_threads(1)


def test_p3m_twolevel_robust_to_outlier_residuals():
    rng = np.random.default_rng(0)
    parts = [rng.uniform(2.0, 98.0, (3100, 3)), np.clip(rng.normal(50.0, 1.5, (876, 3)), 2, 98),
             np.clip(rng.normal(15.0, 0.3, (60, 3)), 2, 98), np.clip(rng.normal(85.0, 0.3, (60, 3)), 2, 98)]
    pos = np.concatenate(parts).astype(np.float32)
    mass = rng.uniform(0.5, 1.5, pos.shape[0]).astype(np.float32)
    errs = _errors(pos, mass, dict(g=32, n_cells=25, max_per_cell=8, max_residual=2048, **SUBMESH))
    for seg, sl in (("core", slice(3100, 3976)), ("clumps", slice(3976, None))):
        tw, de = float(np.median(errs["twolevel"][sl])), float(np.median(errs["dense"][sl]))
        assert tw < 1.5 * de + 1e-3, (seg, tw, de)
