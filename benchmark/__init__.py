"""The benchmark of nbx_torch, the PyTorch and CUDA port of nbx.

`python3 -m benchmark.run --workload <cell> --seed <n> --seconds <s> --trace
<0|1>` runs one cell of BENCHMARK.json and prints its result line. The
harness (`run`, `harness`, `spec`, `trace`, `clock`, `ranks`) takes every
cell and metric as data: configurations in `configs/`, traffic mixes in
`traffic/`, one reader a metric in `metrics/`. The yardstick lives here
too: the scenes (`scenes`), the peaks (`peaks`), the law's operation counts
(`counts`) and the plain reference (`reference/`), which imports nothing of
the program. Nothing here imports JAX or the JAX package `nbx`.
"""
