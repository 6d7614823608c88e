"""nbx_torch — the nbx N-body engine on PyTorch and CUDA (NVIDIA Hopper).

A port of the JAX package `nbx`, module for module and name for name, held
against it by the tests in `tests/test_torch_*.py`. The frame step
(`sim.step`/`sim.run`) runs in eager PyTorch; the direct-sum gravity above
`sim._DENSE_MAX` bodies runs in the hand-written CUDA kernel of
`nbx_torch/csrc/pairwise_f32r.cu`, built with nvcc at first use
(`nbx_torch/ops/_build.py`).

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
