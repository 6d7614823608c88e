"""nbx_torch — the nbx N-body engine on PyTorch and CUDA (NVIDIA Hopper).

A port of the JAX package `nbx`, module for module and name for name, held
against it by the tests in `tests/test_torch_*.py`. The frame step
(`sim.step`/`sim.run`) and the at-scale granular step
(`collisions_scaled.granular_full_kdk_scan`) run in eager PyTorch around two
hand-written CUDA kernels, built with nvcc at first use
(`nbx_torch/ops/_build.py`): the direct-sum gravity above `sim._DENSE_MAX`
bodies (`csrc/pairwise_f32r.cu`) and the fused collision pass
(`csrc/collide_fused.cu`).

This package imports neither `jax` nor `nbx`.
"""

import torch

# Every float32 product in the port is full float32, as the JAX package's
# suite pins its matmuls to "highest": the einsum contractions of
# `forces.accelerations` would otherwise be allowed TF32 (about three decimal
# digits) on the card. Set explicitly, so the result does not depend on
# PyTorch's defaults.
torch.backends.cuda.matmul.allow_tf32 = False
torch.backends.cudnn.allow_tf32 = False
