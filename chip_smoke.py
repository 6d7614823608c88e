#!/usr/bin/env python3
"""On-card check of the PyTorch/CUDA port (`nbx_torch`) on one NVIDIA GPU.

    python3 chip_smoke.py

Builds the port's CUDA kernels from `nbx_torch/csrc/` and drives the port's
paths through their public entry points: the frame step (`scene.make_state`,
`sim.run`, `diagnostics.measure`), the at-scale granular step
(`collisions_scaled.granular_full_kdk_scan`), P3M gravity
(`ops.p3m.p3m_acceleration`, and the granular step with force_impl="p3m"),
the gravity-only integration path (`bench.drift.drift_run`,
`integrators.init_hermite` / `run_hermite`, the `bench latency` and
`bench throughput` mains), every layout of the collision pass (the
`bench granular` and `bench collsplit` mains, the granular demo's
configuration, the scan with its default full-column layout), the spatial
halo-exchange step (`parallel.spatial`, the `bench spatial` main),
the all-gather multi-device paths (`parallel.shard`), the gravity-only
path at each precision of `pairwise_acc` (the `bench throughput`, `drift`
and `latency` entries with `precision`), the layout probes
(`bench.layoutsplit`, `bench.layoutvar`), the strict-sequential frame step
(`sim.run(collision_impl="sequential")`), the two-level P3M residual, the
host API (`interactive.Simulation`, `checkpoint`, `profiling`, `python -m
nbx_torch run`), the renderer (`render.pipeline`), the live server
(`serve.serve`, `--big`), the multi-host entry and per-rank checkpoints
(`parallel.multihost`, `checkpoint.save_sharded`) and the demos (`python -m
nbx_torch demo`):

  0. device: name and power limit; TF32 off
  1. build: nvcc every kernel (sm_90a) at once, print ptxas' resource reports
  2. the gravity kernel K1 against its plain PyTorch version on the card, at
     N = 4,096, rectangular, ragged and separate shapes (softening 1e-20
     too), one source tile, a shorter last split (N = 20,000), mass-0
     padding, the drift gate's sphere (N = 16,384; two launches bitwise)
     and the N = 262,144 cold-collapse disk, each with its split grid; times
     both at N = 262,144 and the kernel at 16,384
  3. the reference scene at the reference size (capacity 300, full physics,
     300 frames), plus 20 frames held against the same frames on the CPU
  4. full physics with the kernel: capacity 4,096, 50 frames; one more frame
     under torch.cuda.set_sync_debug_mode("error")
  5. gravity only at N = 262,144: 5 frames, momentum conservation
  6. the collision kernel against its plain PyTorch version on the card: the
     clustered 192-body scene, the same under budgets that overflow, and the
     131,072-body cloud of the live server; times both at 131,072, and each
     bucket's launch alone with its launch shape (the kernel, csrc/
     collide_fused.cu: runs of collide.RUN lanes folded in run order, units
     of a window's 32 R targets, one-warp teams or, in the tail, a team of
     warps sharing a unit's runs; ops/collide.launch_shape)
  7. the at-scale granular step at the live server's configuration (131,072
     bodies, g = 40, B = 12, PM gravity on a 64^3 mesh): 50 frames of
     granular_full_kdk_scan(n_steps=1, log_events=True), buckets re-sized
     every 5 frames as the cloud collapses, one more under
     set_sync_debug_mode("error"), then 3 steps at N = 4,096 held against the
     same steps on the CPU
  8. the P3M pair kernels K4 and K5 against their plain PyTorch versions on
     the card, on the arguments each pass gives them: the small scenes of
     tests/test_ppkernel.py (K4 and K5 also at eps = 0, their rsqrtf
     instantiations, and twice, bitwise), then the 1M + 30k-core scene at
     the production tune at full width (main pass, residual table,
     residual-residual block), each timed and twice bitwise; K4's grids (R
     targets a thread, the residual-residual block's runs) and K4's and
     K5's partial buffers' sizes
  9. p3m_acceleration at the production tune on that scene: ms per
     evaluation, launches per evaluation, n_uncorrected == 0, the median
     error against the direct sum (K1) below plain PM's in the core and the
     field, one evaluation under set_sync_debug_mode("error")
 10. the 1,048,576-body galaxy merger step of examples/merger_full.py with
     P3M gravity at its scene-census tune: K4 and K5 against their plain
     versions on the arguments the scene's first force evaluation gives
     them (the two-bucket main pass, the residual-residual block, the
     residual table at its affected_cap), each timed and twice bitwise,
     K4's grids, K4's and K5's partial buffers' sizes; 1 warm-up frame and 2
     timed frames of 2 steps, n_overflow == n_uncorrected == 0, one frame
     under set_sync_debug_mode("error"); then 2 steps at N = 4,096 with P3M
     parameters that overflow, held against the same steps on the CPU
 11. the acc+jerk kernel K6 and the potential kernel K3 against their plain
     PyTorch versions on the card: N = 4,096 random, 1,000 targets x 4,096
     sources, 777 x 3,001 ragged, mass-0 padding, K3's self term on a target
     slice, both kernels' split grids, a shape whose last split is shorter
     (N = 20,000), softening 1e-20 (their rsqrtf instantiations), and the
     drift gate's Plummer sphere at N = 16,384 (every target, as phases 12
     and 13 call them; each twice, bitwise; K3's error against its plain
     version in units of the self term) and 262,144 (the first 4,096
     targets); both timed at both sizes
 12. the energy-drift gate at nbx.bench.drift.main's configuration: Plummer
     N = 16,384, 10,000 Kahan-compensated KDK steps with K1, the energy
     through K3 every 100 steps, relative drift < 1e-4; ms/step, launches;
     kernels, wall ms and device ms per step of one 100-step chunk under
     torch.profiler (K1's two launches a step, combine_splits alone in a
     second chunk; not gated); one chunk under set_sync_debug_mode("error")
 13. the 4th-order Hermite scheme with K6 on the same scene and step: 1,000
     steps, the energy through K3 every 100, drift < 1e-4 beside KDK's over
     the same steps; one chunk under set_sync_debug_mode("error"); then 10
     Hermite and 10 KDK steps at N = 1,024 held against the CPU
 14. `bench latency` (N = 1,024 ... 1,048,576) and `bench throughput`
     (N = 262,144) through their mains
 15. the collision pass's other layouts, kernel against plain version on
     the card: full column (K8's function), banded, band-packed and
     compacted on the clustered 192-body scenes (caps that cover and caps
     that overflow: per-cell K, target rows, source lanes, window budget;
     dead bodies), then the granular bench's 131,072-body debris disk at
     each of its five default configurations, each timed (the launches
     alone, kernel and plain, and the whole pass)
 16. K2m: the bucketed pass of phase 7's 131,072-body cloud at 2, 4 and 8
     windows a thread block, bitwise against 1 window a block, W = 4
     against the plain version, each timed; then `bench granular` on that
     cloud at `40,16,12,u0.8x4`
 17. `bench granular` (131,072-body disk, five layouts, PM 128^3) and
     `bench collsplit` (262,144-body cloud) through their mains; the granular
     demo's configuration (32,768-body disk and its m = 2000 core, g = 28,
     K = 12, B = 6, K1 gravity) for 20 frames of 4 steps and one more under
     set_sync_debug_mode("error"); 3 steps of granular_full_kdk_scan with
     every default (full columns, g = 32, K = 16) at N = 4,096 held against
     the same steps on the CPU
 18. the gravity-fused collision kernel K7 against its plain version on the
     card, through the spatial step's local entries: the clustered 192-body
     scenes as slabs of 1-D and 2-D meshes (caps that cover and overflow,
     dead bodies) at eps = 0.5 and eps = 0 (the law's rsqrtf
     instantiation), then the 131,072-body cloud's local grids at
     `bench spatial`'s 32,8,96,104, as D = 1 (the whole grid; at eps = 0
     too, and at R = 1 and 2 targets a thread) and as four virtual slabs on
     the one card (owned rows plus the boundary layers their neighbours
     would send); K7's deltas and partners bitwise K2's on the same windows;
     at zero-overflow caps the slabs' union equal to D = 1; K7 and K2 timed
     on D = 1's windows, and K7 at R = 1, 2, 2, 1 in turns
 19. the spatial halo-exchange step at world size 1 (a process group of this
     process alone, NCCL for the card and gloo for the CPU): `bench
     spatial`'s scene with pm, with p3m (K7's path) and with
     spatial_buckets_for buckets, 20 steps each (mass conserved where
     nothing is dropped); one p3m step under set_sync_debug_mode("error");
     3 steps at N = 4,096 with pm and with p3m on the card and on the CPU
 20. `bench spatial` through its main at its defaults
 21. K2 through the column-slab entry (`packed_collision_blocks_slab`,
     `collide_fused_slab`) against its plain version on the card: the
     clustered 192-body scenes (g = 8, B = 4; caps that cover and that
     overflow, in target rows and in source lanes; dead bodies) as 2, 4 and
     8 slabs, every split's rows reduced (deltas summed, partners by their
     largest) bitwise the whole-grid band-packed pass and its n_overflow
     the whole grid's; the 131,072-body cloud at 32,8,96,104 as 1 slab and
     as 4 slabs, the slabs' n_overflow summing to the whole grid's, and at
     packed_caps_for caps the 4 slabs bitwise the whole grid; the slab
     launches timed against the whole-grid launch
 22. the all-gather paths at world size 1 (NCCL for the card, gloo for the
     CPU): make_sharded_step on BASELINE config 5's 1,048,576-body galaxy
     merger (examples/merger_demo.py's scene, G, eps, h), 1 warm-up and 3
     timed steps (ms/step, pairs/s), momentum conserved, one step under
     set_sync_debug_mode("error"); K1 against its plain version on the
     first 4,096 targets; run_sharded with diag_every (K3's energies, equal
     to the single-device sums); the ring and the 2-D step at N = 262,144
     against the 1-D step (bitwise at D = 1)
 23. the dense full-physics step (make_sharded_physics_step) on phase 4's
     scene padded to 4,096, 20 steps with their counters; 3 steps at
     N = 512 on the card and on the CPU
 24. the sharded granular step (make_sharded_granular_step) on `bench
     spatial`'s scene (131,072-body cloud, 32,8,96,104, PM 128^3) with pm,
     auto (K1) and zero, 20 steps each, beside the spatial step's and the
     scan's ms/step from phase 20; each held at D = 1 against the
     single-device scan (granular_full_kdk_scan, the same layout and
     uniforms) in every counter and partner, under deterministic
     algorithms; one pm step under set_sync_debug_mode("error"); 3 steps at
     N = 4,096 with pm and auto on the card and on the CPU
 25. the precision variants of the direct sum, K1a "f32", K1d "hyb" and K1e
     "bf16" (csrc/pairwise_precision.cu, bf16 in packed bf16x2 registers),
     K1b "fast" (csrc/pairwise_fast.cu) and K1c "mxu" (csrc/pairwise_mxu.cu),
     fast and mxu with their bf16 products on the tensor cores, all five
     with their sources split over a second grid dimension: each kernel
     against its plain version (N = 4,096 random, 1,000 of its targets x
     4,096, 1,000 separate targets x 4,096, 777 x 3,001 ragged, 777 x 255
     (one tile, one split), a shape whose last split is shorter, softening
     1e-20 (the rsqrtf instantiation), mass-0 padding, the cold-collapse
     disk's first 4,096 targets at 262,144; f32 and hyb bitwise, each twice
     on the same inputs bitwise) and against its ladder bar over a float64
     sum (fast's and mxu's bodies' errors also within 1.1x their plain
     version's, either way, at the median and the 99th percentile); fast
     and mxu on 25,600 targets among 1,792 sources by the distance to the
     nearest source (not gated); the split grids of K1 and the five at
     16,384 and 262,144; each timed at 262,144 and at 16,384 in turns with
     K1, with its plain version; `bench.cvt_rate`, the conversion loop
     whose value rate the bounds use (held within 3% of it); `bench.sass` on K1 and the five
     (fast's inner loop runs HMMA, bf16's HMUL2), and on K5, K6, K4 and K3
     (K5's and K4's loops one MUFU.RSQ, MUFU.EX2 and MUFU.RCP a pair, K3's
     one MUFU.RSQ and no other), and on the collision kernel (instructions
     a lane and a pair of its overlap loop at each instantiation: K2's,
     which K2m, K8, the slab entry and the probes launch, with no special
     function; K7's with the law's three a lane a target); `bench throughput` with
     f32r and the five in one process;
     `bench drift` at each precision (BASELINE config 4's drift at the
     gate's step, a measurement: phase 12 keeps the gate), the variant's
     launches on that path, one 100-step chunk under
     set_sync_debug_mode("error"); the latency of one KDK step at 16,384
     and 262,144; 10 steps at N = 1,024 card against CPU
 26. the layout probes: K2 as `bench.layoutsplit` and `bench.layoutvar`
     launch it on bucket 0 of the 131,072-body cloud (32,8, u0.8 caps)
     against its plain version (bounce counts and partners exact), the
     "blocks" layout (the TPU's materialised blocks) bitwise the "desc"
     layout, both launches timed; each probe's main at its defaults
     (131,072 at 32,8 and 262,144 at 40,8), its K2 launches counted
 27. the strict-sequential collision sweep (`csrc/collide_sequential.cu`,
     a card-wide pre-pass and a one-block walk a substep) against its plain
     version (`ops.sequential.sweep_reference`) on the scenes of
     tests/test_sequential.py in contact, a head-on fracture scene, two
     scenes that reach the walk's escape path and a 4,096-body pile (each
     bitwise, or floats to 1e-5 with counters, flags and materials exact;
     the pile twice bitwise, its kernels timed; capacity 5,633 raises);
     the fracture scene through `resolve_collisions_sequential` on the card
     against the CPU with the same draws; then the reference scene at
     capacity 300 through sim.run(collision_impl="sequential"), 300 frames
     timed beside phase 3's Jacobi frame, one launch a substep, every 50th
     substep's sweep held against the plain version, one frame
     sync-checked; one call's kernels by torch.profiler (the pre-pass and
     the walk, no fill); the sweep timed at the reference scene's shapes,
     and the pre-pass, the walk and both alone by CUDA events queued behind
     a sleep kernel
 28. the two-level P3M residual: p3m_acceleration(residual_mode="twolevel")
     on phase 9's 1M + 30k scene at the production tune (K4's main pass
     and K5 a call, no residual-residual launch; submesh 96 / 24 / 128),
     n_uncorrected 0, the core's and the field's median errors within 3x
     phase 9's dense ones plus 1e-3, one evaluation sync-checked; the
     `p3m_cluster` main with `dense twolevel`; 4,096 bodies on the card
     against the CPU
 29. the host API: `interactive.Simulation` on phase 4's scene,
     `run_checkpointed(40, every 10)`, `Simulation.load` and 10 more frames
     from both, bitwise (generator included); `python -m nbx_torch run
     --frames 50 --capacity 300`; `profiling.StepTimer` over 20 frames,
     `profiling.trace`, `profiling.nan_guard`
 30. the renderer: the reference galaxy (capacity 300) through sim.step and
     render_and_advance at 640x360 with 64 impostors, bloom and the
     starfield, 300 frames, physics and render timed apart by CUDA events;
     one frame under set_sync_debug_mode("error"), one profiled, one
     against the CPU with the same state, events and particle draws (1e-4
     of the frame's largest value, with and without impostors); then the
     131,072-body cloud's served frame (`BigLiveSim._advance_and_render`,
     phase 7's configuration, re-sized after a late readback shows an
     overflow), 60 frames beside phase 7's step alone, each re-sized
     layout's first frame without overflow, render_granular alone, one
     frame of the step and render sync-checked and one against the CPU
 31. `serve.serve` in-process on free localhost ports, the reference
     galaxy and `--big` (131,072 bodies), about 10 s each: every endpoint
     answers, frames encoded a second, /frame.png latency; no frame raised
     (the servers' never-cleared n_errors, also in /state)
 32. the multi-host entry at one card: `multihost.initialize` from
     WORLD_SIZE=1, RANK=0, LOCAL_RANK=0 on NCCL, `make_host_mesh`,
     `shard_state_multihost` of the 262,144-body merger, 10 sharded steps
     (K1) and the energy; `checkpoint.save_sharded` / `load_sharded`
     bitwise; `render_sharded` and `render_spatial` at D = 1 bitwise the
     single-device splat (deterministic scatters)
 33. `python -m nbx_torch demo galaxy 30` and `demo merger 131072 10` as
     subprocesses: exit 0, their PNGs non-empty

Every phase raises on failure, so the script exits non-zero; it needs a CUDA
device and has no CPU fallback. The line before the last is the kernels'
JSON record: each kernel's launches on its path, its error against its plain
version (the largest over every check), its time and its plain version's
time at that path's shapes, and its bound (the largest of the bytes over
3.35 TB/s, the FP32 operations over 67 TFLOP/s, the H100 SXM data sheet's
rates, and the special functions over the SFU's 16 per clock per SM,
counted from this run's inputs). K1 is recorded on the frame step's path
(phases 4-5) and timed at 262,144 (ms, bound_ms) and at the drift gate's
16,384 (ms_drift_shape, bound_ms_drift_shape). K4 and K5 are recorded on
the merger step's path (phase 10), K3 on the drift gate's (phase 12) and
K6 on the Hermite path's (phase 13), both timed at its N = 16,384. A call
of K5, K6 or K3 launches two kernels (the pair kernel or split sum, and
its combine), as does K4's on the residual-residual block: `launches`
counts calls, and `ms` times both. The collision
kernel has three entries: collide_fused (K2; the at-scale path, phase 7),
collide_full_column (K8's function; launches on the layout bench's path,
phase 17, timed on the disk's full-column configuration, phase 15) and
collide_fused_multi (K2m; launches on the bench's u0.8x4 path, timed at
W = 4, phase 16). K7 (collide_fused_grav) launches on the spatial step's p3m
path (phase 19) and is timed on D = 1's windows (phase 18). K2 through the
slab entry (collide_fused_slab) launches on the sharded granular step's pm
path (phase 24) and is timed as 1 slab of the cloud (phase 21, the shape
that path gives it at D = 1). The precision variants (pairwise_f32,
pairwise_fast, pairwise_hyb, pairwise_bf16, pairwise_mxu) launch on `bench
drift`'s path at their precision (phase 25: main's warm-up force and the
run's 10,001) and are timed at 262,144 (ms, bound_ms) and at that path's
16,384 (ms_drift_shape, bound_ms_drift_shape); their bounds add the values
they convert from float32 to bf16, over the rate `bench.cvt_rate` measured
(CVT_PEAK), fast's and mxu's the tensor cores' bf16 FLOPs over 989
TFLOP/s, and bf16's 7 packed bf16 products a pair over 133.8 TFLOP/s on
the lanes its FP32 operations use (BF16_PEAK). A call of K1 or of a variant launches two kernels, the split sum
and `combine_splits`: their `launches` count calls of that pair, and `ms`
and `ms_drift_shape` time both (phases 12 and 25 print the combine's device
time on the drift path).
The probes' records (collide_fused_layoutsplit, collide_fused_layoutvar)
count K2's launches in each probe's main and are timed on the probe's
bucket-0 launch (phase 26). A collision pass's bytes count the rows its
windows read and the targets it writes, not the rows of its input (the
"blocks" copy's padding is never read). The strict-sequential sweep
(collide_sequential) replaces no TPU kernel (`nbx` runs it as a fori_loop):
it launches on the sequential frame step's path (phase 27, a call two
launches: the pre-pass and the walk) and is timed at the reference scene's
shapes; its bound counts the overlap tests this run's
sweep made (11 FP32 operations each) and, beside the card's, gives one SM's
(1/132 of the FP32 rate: the sweep is one block). Phases 30-33 port no kernel:
the renderer, the server and the demos run eager PyTorch around K1 and K2,
whose launches on those paths they log. It prints its total and the time of
phases 11-14, 15-17, 18-20, 21-24, 25, 26, 27, 28, 29, 30, 31, 32 and 33
before the kernels line (18 records).
The last line is {"ok": true, "device": {...}}.
"""

from __future__ import annotations

import contextlib
import dataclasses
import functools
import io
import json
import os
import re
import subprocess
import sys
import tempfile
import time

import numpy as np
import torch

from nbx_torch import checkpoint, collisions, collisions_scaled, convert, diagnostics, integrators, profiling, scene, sim
from nbx_torch.bench import collsplit, cvt_rate, drift, granular, latency, p3m_cluster, pp_scenes, throughput, timing
from nbx_torch.bench import collide_turns, layoutsplit, layoutvar, sass, sharded
from nbx_torch.bench import spatial as spatial_bench
from nbx_torch.bench.granular import BOX, granular_cloud
from nbx_torch.collisions import draw_fracture_uniforms
from nbx_torch.config import SimConfig, body_radius, f32, inverse_mass
from nbx_torch.interactive import Simulation
from nbx_torch.ops import _build, collide, p3m, pairwise, ppkernel, sequential
from nbx_torch.ops.pairwise import (pairwise_acc, pairwise_acc_jerk, pairwise_acc_jerk_reference,
                                   pairwise_acc_reference, potential_energy, potential_per_body,
                                   potential_per_body_reference)
from nbx_torch.ops.pm import isolated_green_hat, out_of_box_count, pm_acceleration
from nbx_torch.parallel import shard, spatial
from nbx_torch.render import particles, pipeline, splat
from nbx_torch.render.colormap import tonemap

KERNEL_TOL = 1e-5  # max|kernel - plain| / max|plain|, the bar of tests/test_tpu_only.py
HEADLINE_N = 262_144
SCALED_N = 131_072  # the at-scale live server's default body count
MERGER_N = 1_048_576  # examples/merger_full.py's galaxy merger
DRIFT_N = 16_384  # the energy-drift gate's Plummer sphere (BASELINE config 3)

# The card's peak rates for the bounds (H100 SXM data sheet, dense, 700 W).
FP32_PEAK = 67e12  # FP32 operations per second outside the tensor cores
# bf16 operations per second outside the tensor cores: packed bf16x2, twice
# the FP32 rate on the same lanes (133.8 TFLOP/s on the data sheet)
BF16_PEAK = 133.8e12
HBM_PEAK = 3.35e12  # bytes per second
# Special-function (MUFU) results per second: 16 per clock per SM, 132 SMs at
# the 1.98 GHz boost clock behind the FP32 peak (132 x 128 lanes x 2 x 1.98e9).
SFU_PEAK = 132 * 16 * 1.98e9
# Per pair, counted from each kernel's source: FP32 operations (_OPS) and
# special functions on the SFU (_SFU). K1: 3 differences, r^2 (5), + eps^2,
# m/r^3 (3), the sum (6); one rsqrt. K6: 6 differences, r^2 + eps^2 (6),
# m/s^3 (3), 3 (d.dv)/s^2 (7), the acc sum (6), the jerk terms and sums (12);
# one rsqrt. K3: 3 differences, r^2 + eps^2 (6), the weighted sum (2); one
# rsqrt. K2's overlap test on every source lane:
# 3 differences, r^2 (5), r_i + r_j, its square, the compare; none. The P3M
# law of csrc/pp_law.cuh: 3 differences, r^2 (5), s^2, s, x, x^2, 1 + p x (2),
# the polynomial (8), erfc (2), the weight (6), the sum (6); rsqrt, exp and
# the reciprocal. K5's function also takes the reaction (the weight times m_t
# and a second sum, 7) from the same pair, with no further special function.
K1_PAIR_OPS, K1_PAIR_SFU = 18, 1
K6_PAIR_OPS, K3_PAIR_OPS = 40, 11  # one rsqrt a pair each, as K1
K2_LANE_OPS = 11
PP_PAIR_OPS, PP_PAIR_SFU = 36, 3
PP_REACT_PAIR_OPS = PP_PAIR_OPS + 7
# K7 on every source lane: K2's overlap test and the P3M law, whose
# differences and r^2 (8) the two share; the law's three special functions.
K7_LANE_OPS, K7_LANE_SFU = K2_LANE_OPS + PP_PAIR_OPS - 8, PP_PAIR_SFU
# Float32-to-bf16 conversions per second, counted in values: the packed form
# (cvt.rn.bf16x2.f32, one F2FP for two values), which the kernels issue,
# measured by `python -m nbx_torch.bench.cvt_rate` (phase 25 runs it) at
# 61.968 instructions, CVT_VALUES values, a clock an SM (NVIDIA H100 80GB
# HBM3, 700.00 W; PERF.md, PR 12), at the clock behind the FP32 peak. (The
# scalar form compiles to F2F and runs at 16 a clock an SM, the programming
# guide's rate for conversions.) A bound counts the values a formulation
# converts, whatever instructions a kernel issues for them.
CVT_VALUES = 123.936
CVT_PEAK = 132 * CVT_VALUES * 1.98e9
CVT_VALUES_TOL = 0.03  # phase 25 holds the packed form's measured rate within 3% of CVT_VALUES
# The precision variants of K1, per pair, counted from their sources: FP32
# operations (an FMA counts 2, as in the peak); one rsqrt each. f32
# (csrc/pairwise_precision.cu): 3 differences, r^2 + eps^2 (6), f^3 (2),
# f S (8). hyb (the same source): the cross term (5, as FMAs), r^2 from it
# (3: a sum and an FMA), the floor, w (3), the four sums (7: three FMAs and
# a sum). bf16 (the same source): 3 differences, the float32 sums of r^2
# (3), f^3 (2), the row sums (3); and 7 bf16 products, counted apart
# (VARIANT_PAIR_BF16) at BF16_PEAK. fast
# (csrc/pairwise_fast.cu): 3 differences, r^2 + eps^2 (6), f^3 (2), f - hi
# (1), the tile's sums of the chunks' MMAs (1); mxu (csrc/pairwise_mxu.cu):
# the cross term (5), r^2 from it (4), w (3), w - hi (1), the tile's sums
# (1). Both run their products on the tensor cores, 2 MMAs (16 x 8 x 16,
# 4,096 FLOPs each) for a warp's 256 pairs. Float32-to-bf16 conversions a
# pair, in values, from the formulations: bf16 4 (d's three components and
# f^3), fast and mxu 2 (the weight's hi and lo). The bf16 values go back to
# float32 by a shift or a mask on the integer pipe.
VARIANTS = ("f32", "fast", "hyb", "bf16", "mxu")
VARIANT_PAIR_OPS = {"f32": 19, "fast": 13, "hyb": 19, "bf16": 11, "mxu": 14}
VARIANT_PAIR_BF16 = {"bf16": 7}
VARIANT_PAIR_CVT = {"f32": 0, "fast": 2, "hyb": 0, "bf16": 4, "mxu": 2}
VARIANT_PAIR_TC_FLOPS = {"fast": 2 * 4096 / 256, "mxu": 2 * 4096 / 256}
VARIANT_SITE = {"f32": 51, "fast": 93, "hyb": 302, "bf16": 400, "mxu": 200}  # nbx/ops/pairwise.py
TC_PEAK = 989e12  # dense bf16 FLOP/s on the tensor cores
# max|kernel - plain| / max|plain| of each variant where targets are sources
# (tests/test_torch_cuda.py states the reasons): the plain versions of f32
# and hyb round where the kernels round and sum in their order (their
# splits too), and torch.rsqrt on the card is rsqrtf: measured bitwise (0),
# and both are held bitwise; bf16 sums its rows in torch's order: measured at
# most 1.06e-6 (NVIDIA H100 80GB HBM3, 700 W; PERF.md). fast and mxu sum
# their products on the tensor cores, in an order of their own, so they
# agree with their plain versions to those sums' roundings, not bitwise; and
# a self pair's term cancels (fast: f m_i x_i in o_xyz - p_i o_w; mxu: in
# tmp_xyz - (p_i - c) tmp_w): a few ulps of that term, up to 4.5e-4 of
# max|acc| for fast and 4.6e-4 for mxu. Where no target is a source no self pair's
# term cancels, and every variant is held to SEPARATE_TOL at most. (A target
# within eps of a source cancels that pair's term alike: near_pairs below
# measures fast and mxu on many targets among few sources.)
# (K1's own bar, KERNEL_TOL, stands beside them for the card tests that
# run every split kernel.) f32 and hyb are also held bitwise (BITWISE).
VARIANT_TOL = {"f32r": KERNEL_TOL, "f32": 1e-6, "fast": 2e-3, "hyb": 1e-6, "bf16": 1e-5, "mxu": 2e-3}
BITWISE = ("f32", "hyb")
SEPARATE_TOL = 1e-4
TENSOR_CORE_VARIANTS = ("fast", "mxu")  # their ladder is also held to their plain version's
# The error ladder: max|kernel - float64 sum| / max|float64 sum| on
# tests/test_tpu_only.py's _rand(2048, seed=1). fast's and mxu's are also
# held to their plain version's over every body: each body's max|acc - float64| over
# max|float64|, for the kernel and for the plain version; the ratio of their
# LADDER_QUANTILES lies within LADDER_VS_PLAIN either way. (The ratio of the
# maxima reads the last bits of one body: 1.091x in PR 9's first runs.)
LADDER = {"f32": 1e-3, "fast": 1e-2, "hyb": 0.02, "bf16": 5e-2, "mxu": 0.02}
LADDER_QUANTILES = (0.5, 0.99)
LADDER_VS_PLAIN = 1.1


def variant_tol(precision: str, self_pairs: bool) -> float:
    """A variant's bar against its plain version, on shapes whose targets
    are among the sources (self_pairs) or apart from them."""
    return VARIANT_TOL[precision] if self_pairs else min(VARIANT_TOL[precision], SEPARATE_TOL)


def ladder_ratios(got: torch.Tensor, plain: torch.Tensor, want: torch.Tensor) -> list[float]:
    """The LADDER_QUANTILES of the bodies' errors against the float64 sum
    `want`, the kernel's (got) over the plain version's."""
    scale = want.abs().max()
    k, p = ((x.double() - want).abs().amax(1) / scale for x in (got, plain))
    q = torch.tensor(LADDER_QUANTILES, dtype=torch.float64, device=want.device)
    return (torch.quantile(k, q) / torch.quantile(p, q)).tolist()


def within_ladder(ratios: list[float]) -> bool:
    return all(1 / LADDER_VS_PLAIN < r < LADDER_VS_PLAIN for r in ratios)


def bound(ops: float, sfu: float, nbytes: float, cvt: float = 0.0, tc_flops: float = 0.0,
          bf16_ops: float = 0.0) -> dict:
    """The least time the card could take: the largest of the CUDA cores'
    operations (FP32 over the FP32 peak plus bf16 over the BF16 peak: the
    packed bf16 ones run on the same lanes), the special functions over the
    SFU rate, the type conversions over their rate, the tensor cores' bf16
    FLOPs over their rate and the bytes over the memory rate. bound_by is
    "operations" for any but the last; `pipe` names the term (FP32, SFU,
    CVT, TC or HBM)."""
    times = {"FP32": (ops / FP32_PEAK + bf16_ops / BF16_PEAK) * 1e3, "SFU": sfu / SFU_PEAK * 1e3,
             "CVT": cvt / CVT_PEAK * 1e3, "TC": tc_flops / TC_PEAK * 1e3, "HBM": nbytes / HBM_PEAK * 1e3}
    pipe = max(times, key=times.get)
    return dict(bound_ms=times[pipe], bound_by="bytes" if pipe == "HBM" else "operations", pipe=pipe)


def bound_text(b: dict) -> str:
    return f"bound {b['bound_ms']:.4f} ms ({b['bound_by']}: {b['pipe']})"


def record(b: dict) -> dict:
    """A bound's keys of the kernels line."""
    return dict(bound_ms=b["bound_ms"], bound_by=b["bound_by"])


def log(phase: int, msg: str) -> None:
    print(f"[phase {phase}] {msg}", flush=True)


def check(cond: bool, what: str) -> None:
    if not cond:
        raise RuntimeError(f"check failed: {what}")


def all_finite(*tensors) -> bool:
    return all(bool(torch.isfinite(t).all()) for t in tensors if t is not None)


def cuda_ms(fn, reps: int) -> float:
    """Mean milliseconds per call of fn on the card, by CUDA events."""
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    end.synchronize()
    return start.elapsed_time(end) / reps


def rand_bodies(n: int, seed: int, dev):
    """The `_rand` of tests/test_tpu_only.py."""
    rng = np.random.default_rng(seed)
    pos = torch.tensor(rng.normal(size=(n, 3)) * 20, dtype=torch.float32, device=dev)
    mass = torch.tensor(rng.uniform(0.5, 5, n), dtype=torch.float32, device=dev)
    return pos, mass


def compare(name: str, got: torch.Tensor, want: torch.Tensor, phase: int = 2, tol: float = KERNEL_TOL) -> float:
    abs_err = float((got - want).abs().max())
    rel = abs_err / max(float(want.abs().max()), 1e-30)
    log(phase, f"{name}: max|kernel-plain|={abs_err:.3e} rel={rel:.3e} (tol {tol:g})")
    check(rel < tol, f"{name}: relative error {rel} >= {tol}")
    return abs_err


# N whose last split is shorter, every body a target: 79 tiles, fast's 5
# runs of 16, 16, 16, 16, 15; mxu's 8 of 10, ..., 10, 9; K1's, f32's, hyb's
# and bf16's 27 of 3, ..., 3, 1
SHORT_LAST_SPLIT_N = 20_000


def split_text(precision: str, nt: int, ns: int) -> str:
    """A split kernel's grid at (nt, ns): target blocks x S splits of whole
    tiles."""
    return grid_text(pairwise.SPLIT_KERNELS[precision][0], nt, ns)


def grid_text(rows: int, nt: int, ns: int) -> str:
    """The grid of a split kernel with `rows` targets a block at (nt, ns)."""
    s = pairwise.source_splits(nt, ns, rows)
    per = pairwise.split_tiles(ns, s)
    return f"grid {-(-nt // rows)} x S={s} = {-(-nt // rows) * s} blocks ({per} tile{'s' * (per > 1)} a split)"


def phase_device() -> str:
    check(torch.cuda.is_available(), "torch.cuda.is_available() (this script needs a CUDA device)")
    name = torch.cuda.get_device_name(0)
    smi = timing.device_name(torch.device("cuda", 0))
    check(not torch.backends.cuda.matmul.allow_tf32, "TF32 matmul off")
    check(not torch.backends.cudnn.allow_tf32, "TF32 cuDNN off")
    log(0, f"device {name}; torch {torch.__version__} cuda {torch.version.cuda}; TF32 off")
    print(smi, flush=True)
    return name


def phase_build() -> None:
    t0 = time.perf_counter()
    libs = _build.build_all()
    for name in _build.KERNELS:
        _build.load(name)
    log(1, f"built {len(libs)} kernels in parallel in {time.perf_counter() - t0:.2f} s")
    for lib in libs:
        log(1, f"{lib.relative_to(_build.BUILD_DIR.parent.parent)}")
        for line in lib.with_suffix(".log").read_text().splitlines():
            if "registers" in line or "spill" in line or "smem" in line:
                log(1, f"ptxas: {line.strip()}")


def phase_kernel(dev, n_big: int = HEADLINE_N, n_small: int = DRIFT_N) -> dict:
    """K1 against its plain version (every shape labelled with its split
    grid; two launches bitwise at the drift gate's sphere), then timed at
    n_big on the cold-collapse disk and at n_small on the drift gate's
    sphere (the shape of the path whose launches the kernels line counts)."""
    G, eps = 0.5, 0.5

    def both(label, pos, mass, tgt=None, eps=eps, G=G):
        nt = pos.shape[0] if tgt is None else tgt.shape[0]
        return compare(f"{label}; {split_text('f32r', nt, pos.shape[0])}", pairwise_acc(pos, mass, G, eps, tgt),
                       pairwise_acc_reference(pos, mass, G, eps, tgt))

    pos, mass = rand_bodies(4096, 0, dev)
    err = both("N=4096 random", pos, mass)
    err = max(err, both("1000 targets x 4096 sources", pos, mass, pos[37:1037]))
    sep, _ = rand_bodies(1000, 3, dev)
    # eps^2 = 1e-40, below FLT_MIN: the rsqrtf instantiation, on targets 300
    # away in each coordinate (nothing near goes unsoftened)
    err = max(err, both("1000 targets outside 4096 sources, softening 1e-20", pos, mass, sep + 300.0, eps=1e-20))
    src, m_src = rand_bodies(3001, 1, dev)
    tgt, _ = rand_bodies(777, 2, dev)
    err = max(err, both("777 targets x 3001 sources (ragged)", src, m_src, tgt))
    err = max(err, both("777 targets x 255 sources (one tile: S = 1)", src[:255], m_src[:255], tgt))
    src, m_src = rand_bodies(SHORT_LAST_SPLIT_N, 4, dev)
    err = max(err, both(f"N={SHORT_LAST_SPLIT_N} random (a shorter last split)", src, m_src))
    m_pad = mass.clone()
    m_pad[2048:] = 0.0
    err = max(err, compare("mass-0 padding inert", pairwise_acc(pos, m_pad, G, eps)[:2048],
                           pairwise_acc_reference(pos[:2048], mass[:2048], G, eps)))
    small, _, m_small, G_small, eps_small, _ = drift.gate_scene(n_small, device=dev)
    err = max(err, both(f"Plummer N={n_small} (the drift gate's)", small, m_small, G=G_small, eps=eps_small))
    first = pairwise_acc(small, m_small, G_small, eps_small)
    check(torch.equal(first, pairwise_acc(small, m_small, G_small, eps_small)), "K1: two launches bitwise")

    cfg = SimConfig()
    sc = scene.cold_collapse_disk(n=n_big, seed=0)
    pos = torch.tensor(sc["pos"], device=dev)
    mass = torch.tensor(sc["mass"], device=dev)
    got = pairwise_acc(pos, mass, cfg.G, cfg.softening)
    want = pairwise_acc_reference(pos, mass, cfg.G, cfg.softening, pos[:4096])
    err = max(err, compare(f"N={n_big} cold_collapse_disk, first 4096 targets; "
                           f"{split_text('f32r', n_big, n_big)}", got[:4096], want))
    check(all_finite(got), f"kernel output finite at N={n_big}")

    ms = cuda_ms(lambda: pairwise_acc(pos, mass, cfg.G, cfg.softening), 5)
    plain_ms = cuda_ms(lambda: pairwise_acc_reference(pos, mass, cfg.G, cfg.softening), 1)
    small_ms = cuda_ms(lambda: pairwise_acc(small, m_small, G_small, eps_small), 20)
    rate = n_big**2 / (ms * 1e-3)
    b, b_small = (bound(n * n * K1_PAIR_OPS, n * n * K1_PAIR_SFU, n * (12 + 4 + 12)) for n in (n_big, n_small))
    log(2, f"N={n_big}: kernel {ms:.3f} ms ({rate:.4e} pairs/s), plain {plain_ms:.3f} ms, "
           f"plain/kernel {plain_ms / ms:.2f}x; {bound_text(b)}; kernel/bound {ms / b['bound_ms']:.2f}")
    log(2, f"N={n_small} (the drift gate's sphere): kernel {small_ms:.4f} ms; {bound_text(b_small)}; "
           f"kernel/bound {small_ms / b_small['bound_ms']:.2f}")
    return dict(max_abs_err=err, ms=ms, plain_ms=plain_ms, **record(b), library_ms=None, ms_drift_shape=small_ms,
                bound_ms_drift_shape=b_small["bound_ms"])


def phase_reference(dev, frames: int = 300) -> float:
    cfg = SimConfig().to(dev)
    sc = scene.reference_galaxy(seed=0)
    st = scene.make_state(cfg, sc, dev, seed=0)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    st, evs = sim.run(st, cfg, frames)
    torch.cuda.synchronize()
    dt = time.perf_counter() - t0
    check(all_finite(st.pos, st.vel, st.acc, st.mass, st.temp, st.contact), f"state finite after {frames} frames")
    n_alive = int(st.n_alive)
    check(1 <= n_alive <= cfg.capacity, f"1 <= n_alive={n_alive} <= {cfg.capacity}")
    log(3, f"capacity 300, {frames} frames in {dt:.3f} s ({dt / frames * 1e3:.3f} ms/frame); n_alive {n_alive}; "
           f"merges {int(evs.n_merges.sum())} fractures {int(evs.n_fractures.sum())} "
           f"bounces {int(evs.n_bounces.sum())} evicted {int(evs.n_evicted.sum())} "
           f"dropped {int(evs.n_dropped.sum())}")

    # The same 20 frames on the card and on the CPU, with the same fracture
    # draws: float32 summation order differs, slots and events must not.
    cpu_cfg = SimConfig()
    a, b = scene.make_state(cfg, sc, dev), scene.make_state(cpu_cfg, sc, "cpu")
    h = sim.substep_size(cfg)
    gen = torch.Generator().manual_seed(1)
    for _ in range(20 * cfg.sub_steps):
        d = draw_fracture_uniforms(cpu_cfg, gen, "cpu")
        a, ea = sim.substep(a, cfg, h, draws=d.to(dev))
        b, eb = sim.substep(b, cpu_cfg, h, draws=d)
        for f in ("n_merges", "n_fractures", "n_bounces", "n_evicted", "n_dropped"):
            check(int(getattr(ea, f)) == int(getattr(eb, f)), f"{f} equal on card and CPU")
    check(torch.equal(a.alive.cpu(), b.alive) and torch.equal(a.seq.cpu(), b.seq), "slots equal on card and CPU")
    for f in ("pos", "vel", "temp"):
        x, y = getattr(a, f).cpu(), getattr(b, f)
        err = float((x - y).abs().max()) / max(float(y.abs().max()), 1e-30)
        log(3, f"20 frames card vs CPU: {f} max rel err {err:.3e} (tol 1e-3)")
        check(err < 1e-3, f"{f} card vs CPU after 20 frames")
    return dt / frames * 1e3


def phase_full_physics(dev, capacity: int = 4096, n_disk: int = 3000, frames: int = 50) -> float:
    cfg = SimConfig(capacity=capacity).to(dev)
    st = scene.make_state(cfg, scene.reference_galaxy(n_disk=n_disk, seed=0), dev, seed=0)
    for _ in range(2):  # warm-up: allocator, kernel load
        st, _ = sim.step(st, cfg)
    torch.cuda.synchronize()

    pairwise_acc.launches = 0  # count the main path's launches from here
    collide.collide_fused.launches = 0
    t0 = time.perf_counter()
    st, evs = sim.run(st, cfg, frames)
    torch.cuda.synchronize()
    dt = time.perf_counter() - t0
    check(pairwise_acc.launches == frames * cfg.sub_steps,
          f"kernel launched {pairwise_acc.launches} times in {frames} frames, want {frames * cfg.sub_steps}")
    check(all_finite(st.pos, st.vel, st.acc, st.mass, st.temp, st.contact), "state finite")
    diag = diagnostics.measure(st, cfg)
    check(all_finite(*(getattr(diag, f.name) for f in dataclasses.fields(diag))), "diagnostics finite")
    log(4, f"capacity {capacity}, {frames} frames: {dt / frames * 1e3:.3f} ms/frame; n_alive {int(st.n_alive)}; "
           f"merges {int(evs.n_merges.sum())} fractures {int(evs.n_fractures.sum())} "
           f"bounces {int(evs.n_bounces.sum())} evicted {int(evs.n_evicted.sum())} "
           f"dropped {int(evs.n_dropped.sum())}; E={float(diag.energy):.6e}")

    before = pairwise_acc.launches
    torch.cuda.set_sync_debug_mode("error")
    try:
        st, _ = sim.step(st, cfg)
    finally:
        torch.cuda.set_sync_debug_mode("default")
    torch.cuda.synchronize()
    check(pairwise_acc.launches - before == cfg.sub_steps, "kernel ran in the sync-checked frame")
    log(4, "one frame ran under set_sync_debug_mode('error'): no host sync in sim.step")
    return dt / frames * 1e3


def phase_headline(dev, n: int = HEADLINE_N, frames: int = 5) -> float:
    cfg = SimConfig(capacity=n, collisions=False).to(dev)
    st = scene.make_state(cfg, scene.cold_collapse_disk(n=n, seed=0), dev, seed=0)

    def momentum(s):
        return (s.mass.double()[:, None] * s.vel.double()).sum(0)

    p0 = momentum(st)
    before = pairwise_acc.launches
    t0 = time.perf_counter()
    st, _ = sim.run(st, cfg, frames)
    torch.cuda.synchronize()
    dt = time.perf_counter() - t0
    n_eval = frames * cfg.sub_steps
    check(pairwise_acc.launches - before == n_eval, f"kernel launched {n_eval} times in {frames} frames")
    check(all_finite(st.pos, st.vel), "positions and velocities finite")
    drift = float((momentum(st) - p0).norm()) / float((st.mass.double() * st.vel.double().norm(dim=1)).sum())
    log(5, f"N={n} gravity only, {frames} frames: {dt / n_eval * 1e3:.3f} ms per force evaluation "
           f"(frame wall time / substeps); |dP| / sum m|v| = {drift:.3e} (tol 1e-5)")
    check(drift < 1e-5, "momentum conserved")
    return dt / n_eval * 1e3


def clustered_scene(n: int = 192, seed: int = 7):
    """The clustered scene of tests/test_collisions_scaled.py: a uniform
    background and a dense clump, so windows land in both buckets."""
    rng = np.random.default_rng(seed)
    n_bg = n * 2 // 3
    bg = rng.uniform(10, 90, (n_bg, 3))
    clump = rng.normal(35.0, 2.5, (n - n_bg, 3))
    pos = np.clip(np.concatenate([bg, clump]), 1.0, 99.0).astype(np.float32)
    vel = rng.normal(0, 1.0, (n, 3)).astype(np.float32)
    mass = rng.uniform(2.0, 8.0, n).astype(np.float32)
    return pos, vel, mass


def collide_inputs(pos, vel, mass, radius_scale, dev):
    t = [torch.tensor(x, device=dev) for x in (pos, vel, mass)]
    radius = body_radius(t[2], torch.zeros_like(t[2], dtype=torch.int32),
                         SimConfig().to(dev).materials) * radius_scale
    return (*t, radius)


def collide_both(inputs, box, g, b, buckets):
    """The bucketed pass through the kernel and through its plain version."""
    args = (*inputs, box, g, b, buckets, 0.2, 0.5)
    return (collide._bucketed_pass(*args, collide.collide_fused),
            collide._bucketed_pass(*args, collide.collide_fused_reference))


def check_collide(name, got, want, phase: int = 6) -> float:
    """Deltas to KERNEL_TOL of each field's largest magnitude; partners,
    bounces, overflow and the cell-size flag exactly."""
    err = 0.0
    for i, field in enumerate(("dvel", "dpos", "dtemp")):
        abs_err = compare(f"{name} {field}", got[i], want[i], phase=phase)
        err = max(err, abs_err)
    check(torch.equal(got[3]["j"], want[3]["j"]), f"{name}: partners equal")
    for i, field in ((4, "n_bounces"), (5, "n_overflow"), (6, "cell_too_small")):
        check(int(got[i]) == int(want[i]), f"{name}: {field} equal ({int(got[i])} vs {int(want[i])})")
    log(phase, f"{name}: partners equal ({int((got[3]['j'] >= 0).sum())} bodies with one), "
               f"n_bounces {int(got[4])}, n_overflow {int(got[5])}, cell_too_small {bool(got[6])}")
    return err


def phase_collide_kernel(dev, n_big: int = SCALED_N) -> dict:
    pos, vel, mass = clustered_scene()
    inputs = collide_inputs(pos, vel, mass, 2.0, dev)
    buckets = collide.bucketed_layout_for(pos, BOX, 8, 4, split_quantile=0.6)
    err = check_collide(f"clustered n=192 g=8 B=4 buckets={buckets}", *collide_both(inputs, BOX, 8, 4, buckets))
    tiny = ((24, 64, 8), (128, 256, 8))
    inputs = collide_inputs(pos, vel, mass, 4.0, dev)
    got, want = collide_both(inputs, BOX, 8, 4, tiny)
    err = max(err, check_collide(f"clustered n=192, radius x4, tiny budgets {tiny}", got, want))
    check(int(got[5]) > 0, "the tiny budgets overflow")

    box = BOX * (n_big / SCALED_N) ** (1.0 / 3.0)
    pos, vel, mass = granular_cloud(n_big, seed=0, box=box)
    buckets = collide.bucketed_layout_for(pos, box, 40, 12)
    inputs = collide_inputs(pos, vel, mass, 1.0, dev)
    got, want = collide_both(inputs, box, 40, 12, buckets)
    err = max(err, check_collide(f"granular_cloud n={n_big} g=40 B=12 buckets={buckets}", got, want))
    check(int(got[4]) > 0 and int(got[5]) == 0, "contacts found, nothing overflows")

    # time the kernel launches of one pass (every bucket) against the plain
    # version on the same layout; collide_turns' k2 case times the same
    # launches
    calls = collide_turns.cloud_calls(inputs, box, 40, 12, buckets)

    def run(fused, cs=calls):
        for c in cs:
            fused(*c)

    run(collide.collide_fused)  # warm-up
    ms = cuda_ms(lambda: run(collide.collide_fused), 5)
    plain_ms = cuda_ms(lambda: run(collide.collide_fused_reference), 1)
    pass_ms = cuda_ms(lambda: collide.binned_collision_pass(*inputs, box, 40, band_cells=12, buckets=buckets), 5)
    lanes = sum(int((c[3][:, 1].long() * c[3][:, 3::2].long().sum(1)).sum()) for c in calls)
    nbytes = n_big * (32 + 4 + 1 + 32 + 4) + sum(c[3].numel() * 4 for c in calls)
    b = bound(lanes * K2_LANE_OPS, 0, nbytes)
    log(6, f"n={n_big}: kernel {ms:.4f} ms per pass ({len(calls)} launches), plain {plain_ms:.3f} ms, "
           f"plain/kernel {plain_ms / ms:.2f}x; whole binned_collision_pass with the kernel {pass_ms:.3f} ms; "
           f"{lanes} source lanes, {bound_text(b)}")
    bucket_ms = []
    for i, c in enumerate(calls):  # each bucket's launch alone
        one = cuda_ms(lambda: run(collide.collide_fused, [c]), 20)
        win, t_rows, s_capw = c[3], c[8], c[9]
        occupied = win[:, 1] > 0
        lanes_i = int((win[:, 1].long() * win[:, 3::2].long().sum(1)).sum())
        log(6, f"bucket {i} (t_rows {t_rows}, s_capw {s_capw}): {one:.4f} ms a launch, {win.shape[0]} windows, "
               f"{int(occupied.sum())} with targets ({float(win[occupied, 1].float().mean()):.1f} a window), "
               f"{lanes_i} source lanes; {collide.launch_shape(win.shape[0], t_rows)}")
        bucket_ms.append(one)
    return dict(max_abs_err=err, ms=ms, plain_ms=plain_ms, **record(b), library_ms=None, bucket_ms=bucket_ms)


def server_setup(dev, n: int = SCALED_N, g: int = 40, b: int = 12, pm_grid: int = 64):
    """BigLiveSim's configuration: the cloud scene, its box, the buckets and
    the Green's-function transform, computed once per scene."""
    box = BOX * (n / SCALED_N) ** (1.0 / 3.0)
    pos, vel, mass = granular_cloud(n, seed=0, box=box)
    st = collisions_scaled.make_granular_state(pos, vel, mass, seed=0, device=dev)
    cfg = SimConfig(G=0.5, dt=0.016, sub_steps=1, merge_time=0.25, fracture_threshold=8.0).to(dev)
    buckets = collide.bucketed_layout_for(pos, box, g, b)
    kw = dict(n_cells=g, band_cells=b, buckets=buckets, force_impl="pm", pm_grid=pm_grid,
              log_events=True, green_hat=isolated_green_hat(box, pm_grid, device=dev))
    return st, cfg, box, kw


# The cloud collapses under its own gravity, and buckets sized once per scene
# (as the JAX package's BigLiveSim sizes them) overflow from about frame 22 on. Phase 7 re-sizes
# them from the current positions every RESIZE_EVERY frames, host-side and
# untimed, with BLOCK_SLACK headroom for the tail bucket's growth in between.
RESIZE_EVERY = 5
BLOCK_SLACK = 2.0


def phase_scaled(dev, frames: int = 50) -> float:
    st, cfg, box, kw = server_setup(dev)
    n = st.pos.shape[0]
    log(7, f"N={n} box={box:g} g={kw['n_cells']} B={kw['band_cells']} buckets={kw['buckets']} "
           f"pm_grid={kw['pm_grid']}")
    for _ in range(2):  # warm-up: allocator, cuFFT plans, kernel load
        st, _, _ = collisions_scaled.granular_full_kdk_scan(st, cfg, box, 1, **kw)
    torch.cuda.synchronize()

    collide.collide_fused.launches = 0  # the at-scale path's launches from here
    pairwise_acc.launches = 0
    totals = []
    want_launches = 0
    dt = 0.0
    for f0 in range(0, frames, RESIZE_EVERY):
        kw["buckets"] = collide.bucketed_layout_for(st.pos.cpu().numpy(), box, kw["n_cells"],
                                                    kw["band_cells"], block_slack=BLOCK_SLACK)
        t0 = time.perf_counter()
        for _ in range(min(RESIZE_EVERY, frames - f0)):  # one scan call per frame, as the server runs it
            st, tot, ev = collisions_scaled.granular_full_kdk_scan(st, cfg, box, 1, **kw)
            totals.append(tot)
            want_launches += len(kw["buckets"])
        torch.cuda.synchronize()
        dt += time.perf_counter() - t0
    check(collide.collide_fused.launches == want_launches,
          f"kernel launched {collide.collide_fused.launches} times in {frames} steps, want {want_launches}")
    check(all_finite(st.pos, st.vel, st.mass, st.temp, st.contact_t), "state finite")
    agg = {k: torch.stack([t[k] for t in totals]) for k in totals[0]}
    n_ovf = int(agg["n_overflow"].max())
    small = bool(agg["cell_too_small"].any())
    n_b = int(agg["n_bounces"].sum())
    check(n_ovf == 0, f"n_overflow {n_ovf} == 0 in every step")
    check(not small, "cell_too_small is False")
    check(n_b > 0, "bounces fired")
    log(7, f"N={n}, {frames} steps: {dt / frames * 1e3:.3f} ms/step; bounces {n_b} "
           f"merges {int(agg['n_merges'].sum())} fractures {int(agg['n_fractures'].sum())} "
           f"dropped {int(agg['n_dropped'].sum())} overflow {n_ovf}; "
           f"alive {int((st.mass > 0).sum())}; out_of_box_count {int(out_of_box_count(st.pos, box))}; "
           f"{collide.collide_fused.launches} kernel launches; last buckets {kw['buckets']}")

    before = collide.collide_fused.launches
    torch.cuda.set_sync_debug_mode("error")
    try:
        st, _, _ = collisions_scaled.granular_full_kdk_scan(st, cfg, box, 1, **kw)
    finally:
        torch.cuda.set_sync_debug_mode("default")
    torch.cuda.synchronize()
    check(collide.collide_fused.launches - before == len(kw["buckets"]),
          "kernel ran in the sync-checked step")
    check(pairwise_acc.launches == 0, "PM gravity: the direct-sum kernel did not run")
    log(7, "one step ran under set_sync_debug_mode('error'): no host sync in granular_full_kdk_scan")
    return dt / frames * 1e3


SCALED_CPU_TOL = 1e-4  # card vs CPU: PM's atomic deposit and another FFT library


def phase_scaled_vs_cpu(dev, n: int = 4096, steps: int = 3) -> None:
    a, cfg, box, kw = server_setup(dev, n=n, g=16, b=4, pm_grid=32)
    b, cpu_cfg, _, kw_cpu = server_setup("cpu", n=n, g=16, b=4, pm_grid=32)
    check(kw["buckets"] == kw_cpu["buckets"], "same buckets")
    gen = torch.Generator().manual_seed(3)
    draws = [draw_fracture_uniforms(cpu_cfg, gen, "cpu") for _ in range(steps)]
    a, ta, ea = collisions_scaled.granular_full_kdk_scan(a, cfg, box, steps, draws=[d.to(dev) for d in draws], **kw)
    b, tb, eb = collisions_scaled.granular_full_kdk_scan(b, cpu_cfg, box, steps, draws=draws, **kw_cpu)
    for k in ta:
        check(torch.equal(ta[k].cpu(), tb[k]), f"total {k} equal on card and CPU ({ta[k].tolist()} vs {tb[k].tolist()})")
    for f in ("n_merges", "n_fractures", "n_bounces", "n_overflow", "n_dropped", "merge_mask",
              "fracture_mask", "spawn_mask"):
        check(torch.equal(getattr(ea, f).cpu(), getattr(eb, f)), f"events {f} equal on card and CPU")
    check(torch.equal(a.partner.cpu(), b.partner) and torch.equal(a.mat.cpu(), b.mat),
          "partners and materials equal on card and CPU")
    for f in ("pos", "vel", "mass", "temp", "contact_t"):
        x, y = getattr(a, f).cpu(), getattr(b, f)
        err = float((x - y).abs().max()) / max(float(y.abs().max()), 1e-30)
        log(7, f"N={n}, {steps} steps card vs CPU: {f} max rel err {err:.3e} (tol {SCALED_CPU_TOL:g})")
        check(err < SCALED_CPU_TOL, f"{f} card vs CPU after {steps} steps")
    log(7, f"N={n}: totals {{{', '.join(f'{k}: {int(v)}' for k, v in tb.items())}}} equal on card and CPU")


# ---- P3M: K4 and K5 ------------------------------------------------------------

def residual_inputs(pos, mass, box, g, k, m, sort=None):
    """(res_idx, res_valid, sort) of the bodies past K in their cells."""
    sort = sort if sort is not None else p3m.cell_sort(pos, box, g)
    res_idx, res_valid = p3m.take_rows(p3m.overflowing(sort, k)[1], m)
    return res_idx, res_valid, sort


def check_pass(phase: int, name, wrapper, plain, args, reps: int = 0, twice: bool = False) -> dict:
    """The kernel against its plain version on the same arguments (with
    twice, a second call bitwise the first); with reps, the kernel's time
    by CUDA events (reps launches after a warm-up) and the plain version's
    (one call)."""
    got = wrapper(*args)
    err = compare(name, got, plain(*args), phase=phase)
    if twice:
        check(torch.equal(got, wrapper(*args)), f"{name}: a second call gives the same bits")
        log(phase, f"{name}: a second call gives the same bits")
    out = dict(max_abs_err=err)
    if reps:
        out["ms"] = cuda_ms(lambda: wrapper(*args), reps)
        out["plain_ms"] = cuda_ms(lambda: plain(*args), 1)
    return out


def rr_text(rr_args) -> str:
    """K4's residual-residual grid at these arguments: items x runs of the
    one strip, from M alone, and the partials' bytes."""
    m = rr_args[5]
    s, run = ppkernel.rr_runs(m)
    return (f"M={m}: grid {rr_args[3].shape[0]} items x S={s} runs of {run} rows = {rr_args[3].shape[0] * s} blocks, "
            f"float32 partials [{s}, {m}, 3] = {ppkernel.rr_partial_bytes(m)} bytes")


def pp_bounds(phase: int, main_args, table_args) -> tuple[dict, dict]:
    """(K4, K5) bounds of one evaluation's passes, counted from their
    arguments: the kept pairs of the main pass and the live ones of the
    residual passes; each input byte read once, each output written once.
    K4's is that of its two launches' work together."""
    win = main_args[3].long()
    main_pairs = int((win[:, 1] * win[:, 3::2].sum(1)).sum())
    n = main_args[6]
    row_out, aff_len = table_args[1], table_args[5]
    n_live = int((row_out >= 0).sum())
    n_aff = int(aff_len.sum())
    rr_pairs, table_pairs = n_live * n_live, n_live * n_aff
    k4 = bound((main_pairs + rr_pairs) * PP_PAIR_OPS, (main_pairs + rr_pairs) * PP_PAIR_SFU,
               n * (16 + 4 + 12) + win.numel() * 4 + n_live * (16 + 4 + 12))
    k5 = bound(table_pairs * PP_REACT_PAIR_OPS, table_pairs * PP_PAIR_SFU, (n_live + n_aff) * (16 + 4 + 12))
    log(phase, f"pairs: main pass {main_pairs}, residual-residual {rr_pairs}, residual table {table_pairs} "
               f"({n_live} live residuals, {n_aff} kept bodies in the affected cells)")
    return k4, k5


def pp_full_width(phase: int, label: str, pos, mass, G: float, eps: float, box: float, tune: dict,
                  reps: int = 5) -> tuple[dict, dict]:
    """K4 (the main pass and the residual-residual block) and K5 (the
    residual table) on the arguments one P3M evaluation at `tune` (the keys
    of p3m_tune_for) gives them on this scene, each against its plain
    version and timed, K5 twice bitwise; every body past K gets its
    correction (no cell dropped, n_missed 0). Returns the kernels-line entries of K4 (per
    evaluation: both launches) and K5, bounds included."""
    g, k = tune["n_cells"], tune["max_per_cell"]
    a = p3m.smoothing_length(box, g)
    ri, rv, sort = residual_inputs(pos, mass, box, g, k, tune["max_residual"])
    main_args, n_ovf = ppkernel._main_pass(pos, mass, G, a, box, g, k, eps, tune.get("pp_buckets"), sort)
    rr_args = ppkernel._rr_pass(pos, mass, G, a, box, ri, rv, eps)
    table_args, n_missed = ppkernel._table_pass(pos, mass, G, a, box, g, k, ri, rv, eps,
                                                tune.get("affected_cap", 256), sort)
    n_past, n_res = int(p3m.overflowing(sort, k)[0]), int(rv.sum())
    n_aff = int((table_args[5] > 0).sum())
    log(phase, f"{label}: g={g} K={k} pp_buckets={tune.get('pp_buckets')}: {n_past} bodies past K, "
               f"{n_res} residuals, {n_aff} affected cells, {main_args[3].shape[0]} main-pass work items, "
               f"n_overflow {int(n_ovf)}, n_missed {int(n_missed)}")
    check(int(n_ovf) == n_past, f"{label}: the main pass drops no cell (n_overflow {int(n_ovf)} == {n_past})")
    check(n_res == n_past and int(n_missed) == 0, f"{label}: every body past K corrected")
    log(phase, f"{label} K4: {ppkernel.THREADS} threads of R = {ppkernel.TARGETS} targets a block; main pass "
               f"{main_args[3].shape[0]} items of {ppkernel.ITEM}; residual-residual {rr_text(rr_args)}")
    main = check_pass(phase, f"K4 main pass {label}", ppkernel.pp_short, ppkernel.pp_short_reference,
                      main_args, reps, twice=True)
    rr = check_pass(phase, f"K4 residual-residual {label}", ppkernel.pp_short, ppkernel.pp_short_reference,
                    rr_args, reps, twice=True)
    table = check_pass(phase, f"K5 residual table {label}", ppkernel.pp_react, ppkernel.pp_react_reference,
                       table_args, reps, twice=True)
    m, a = table_args[0].shape[0], table_args[4].shape[0]
    blocks, (fwd_bytes, react_bytes) = ppkernel.react_blocks(a, k), ppkernel.react_partial_bytes(m, a, k)
    log(phase, f"{label} K5: grid {blocks} blocks of {ppkernel.REACT_ROWS} kept rows ({a} affected cells x "
               f"K {k}) x {ppkernel.REACT_SPLITS} runs of the live residuals; float32 "
               f"partials: forward [{blocks}, {m}, 3] = {fwd_bytes} bytes, reactions "
               f"[{ppkernel.REACT_SPLITS}, {blocks * ppkernel.REACT_ROWS}, 3] = {react_bytes} bytes")
    b4, b5 = pp_bounds(phase, main_args, table_args)
    for name, r in (("K4 main pass", main), ("K4 residual-residual", rr), ("K5 residual table", table)):
        log(phase, f"{label} {name}: kernel {r['ms']:.3f} ms, plain {r['plain_ms']:.3f} ms")
    log(phase, f"{label}: K4 per evaluation {main['ms'] + rr['ms']:.3f} ms, {bound_text(b4)}; "
               f"K5 {table['ms']:.3f} ms, {bound_text(b5)}")
    k4 = dict(max_abs_err=max(main["max_abs_err"], rr["max_abs_err"]), ms=main["ms"] + rr["ms"],
              plain_ms=main["plain_ms"] + rr["plain_ms"], **record(b4), library_ms=None)
    k5 = dict(max_abs_err=table["max_abs_err"], ms=table["ms"], plain_ms=table["plain_ms"], **record(b5),
              library_ms=None)
    return k4, k5


def phase_pp_kernels(dev, n_big: int = 1_000_000, n_core: int = 30_000) -> tuple[float, float]:
    """K4 and K5 against their plain versions on the small scenes of
    tests/test_ppkernel.py and at the production tune on the 1M + 30k-core
    scene. Returns the largest error of each."""
    cpu = torch.device("cpu")
    err4 = err5 = 0.0
    for case, name in pp_scenes.MAIN_CASES.items():
        pos, mass, G, a, box, g, k, eps, buckets = pp_scenes.main_case(case)
        if buckets == "census":
            buckets = ppkernel.pp_buckets_for(pos, box, g, k)
            check(buckets is not None, f"{name}: the census buckets the scene")
        (args, ovf), (_, ovf_cpu) = (
            ppkernel._main_pass(torch.from_numpy(pos).to(d), torch.from_numpy(mass).to(d), G, a, box, g,
                                k, eps, buckets, None) for d in (dev, cpu))
        check(int(ovf) == int(ovf_cpu), f"{name}: n_overflow {int(ovf)} on the card, {int(ovf_cpu)} on the CPU")
        r = check_pass(8, f"K4 {name} (n_overflow {int(ovf)})", ppkernel.pp_short, ppkernel.pp_short_reference,
                       args, twice=True)
        err4 = max(err4, r["max_abs_err"])
        # eps = 0: eps^2 below FLT_MIN, K4's rsqrtf instantiation
        z_args, _ = ppkernel._main_pass(torch.from_numpy(pos).to(dev), torch.from_numpy(mass).to(dev), G, a, box, g,
                                        k, 0.0, buckets, None)
        r = check_pass(8, f"K4 {name}, eps 0", ppkernel.pp_short, ppkernel.pp_short_reference, z_args)
        err4 = max(err4, r["max_abs_err"])

    for case, name in pp_scenes.RESIDUAL_CASES.items():
        pos, mass, G, a, box, g, k, m, cap, eps = pp_scenes.residual_case(case)
        missed = []
        for d in (dev, cpu):
            tp, tm = torch.from_numpy(pos).to(d), torch.from_numpy(mass).to(d)
            ri, rv, sort = residual_inputs(tp, tm, box, g, k, m)
            t_args, n_missed = ppkernel._table_pass(tp, tm, G, a, box, g, k, ri, rv, eps, cap, sort)
            missed.append(int(n_missed))
            if d == dev:
                r = check_pass(8, f"K5 {name}", ppkernel.pp_react, ppkernel.pp_react_reference, t_args, twice=True)
                err5 = max(err5, r["max_abs_err"])
                # eps = 0: eps^2 below FLT_MIN, K5's rsqrtf instantiation
                z_args, _ = ppkernel._table_pass(tp, tm, G, a, box, g, k, ri, rv, 0.0, cap, sort)
                r = check_pass(8, f"K5 {name}, eps 0", ppkernel.pp_react, ppkernel.pp_react_reference, z_args)
                err5 = max(err5, r["max_abs_err"])
                for e, label in ((eps, ""), (0.0, ", eps 0")):
                    rr_args = ppkernel._rr_pass(tp, tm, G, a, box, ri, rv, e)
                    r = check_pass(8, f"K4 residual-residual {name}{label} ({rr_text(rr_args)})", ppkernel.pp_short,
                                   ppkernel.pp_short_reference, rr_args, twice=not label)
                    err4 = max(err4, r["max_abs_err"])
        check(missed[0] == missed[1] and (missed[0] > 0) == (case == "affected_cap"),
              f"{name}: n_missed {missed[0]} on the card, {missed[1]} on the CPU")

    # full width: the 1M + 30k-core scene at the production tune
    pos_np, mass_np, _ = p3m_cluster.cluster_scene(n_big, n_core)
    tp, tm = torch.from_numpy(pos_np).to(dev), torch.from_numpy(mass_np).to(dev)
    tune = p3m_cluster.PRODUCTION_TUNE
    k4, k5 = pp_full_width(8, f"N={n_big} core {n_core}", tp, tm, 1.0, tune["eps"], p3m_cluster.BOX, tune)
    return max(err4, k4["max_abs_err"]), max(err5, k5["max_abs_err"])


def reset_pp_counts() -> None:
    ppkernel.pp_short.launches = 0
    ppkernel.pp_react.launches = 0


def phase_p3m(dev, n: int = 1_000_000, n_core: int = 30_000, evals: int = 5) -> tuple[float, dict]:
    pos_np, mass_np, n_field = p3m_cluster.cluster_scene(n, n_core)
    pos, mass = torch.from_numpy(pos_np).to(dev), torch.from_numpy(mass_np).to(dev)
    tune, box = p3m_cluster.PRODUCTION_TUNE, p3m_cluster.BOX
    acc, unc = p3m.p3m_acceleration(pos, mass, 1.0, box, **tune)  # warm-up: cuFFT plans, allocator
    torch.cuda.synchronize()

    reset_pp_counts()  # P3M's path starts here
    uncs = []
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(evals):
        acc, unc = p3m.p3m_acceleration(pos, mass, 1.0, box, **tune)
        uncs.append(unc)
    end.record()
    end.synchronize()
    ms = start.elapsed_time(end) / evals
    k4, k5 = ppkernel.pp_short.launches, ppkernel.pp_react.launches
    check(k4 == 2 * evals and k5 == evals,
          f"{k4} K4 and {k5} K5 launches in {evals} evaluations, want {2 * evals} and {evals}")
    n_unc = int(torch.stack(uncs).max())
    check(n_unc == 0, f"n_uncorrected {n_unc} == 0")
    check(all_finite(acc), "accelerations finite")
    errs = p3m_cluster.sample_errors(pos, mass, acc, n_field)
    pm_errs = p3m_cluster.sample_errors(pos, mass, pm_acceleration(pos, mass, 1.0, box, g=tune["g"]), n_field)
    log(9, f"N={n} core {n_core} at {tune}: {ms:.3f} ms per evaluation over {evals}; "
           f"K4 {k4 // evals} and K5 {k5 // evals} launches per evaluation; n_uncorrected {n_unc}")
    log(9, f"median relative error vs direct sum (K1), 4096-body sample: P3M {errs}; PM g={tune['g']} {pm_errs}")
    for part in ("core_median", "field_median"):
        check(errs[part] < pm_errs[part], f"P3M {part} {errs[part]:.3e} < PM's {pm_errs[part]:.3e}")

    torch.cuda.set_sync_debug_mode("error")
    try:
        acc, unc = p3m.p3m_acceleration(pos, mass, 1.0, box, **tune)
    finally:
        torch.cuda.set_sync_debug_mode("default")
    torch.cuda.synchronize()
    check(int(unc) == 0 and ppkernel.pp_short.launches == 2 * evals + 2, "kernels ran in the sync-checked evaluation")
    log(9, "one evaluation ran under set_sync_debug_mode('error'): no host sync in p3m_acceleration")
    return ms, errs


MERGER_CFG = dict(G=0.5, dt=0.35, sub_steps=1, softening=0.5, merge_time=0.5,
                  fracture_threshold=25.0, max_fractures=32)


def merger_setup(dev, n: int, tune: dict | None = None):
    """examples/merger_full.py's scene and configuration: the scene-census
    P3M tune (or an explicit one with p3m_tune_for's keys), the collision
    grid from the largest radius, buckets from bucketed_layout_for, the
    smoothed Green's function once per scene.

    One change: merger_full clamps the collision grid at 64 cells, and at
    n = 1,048,576 bucketed_layout_for (the JAX package's as the port's)
    rejects every band at 64 (the tail windows of the cores need 20,763 to
    45,828 fused source lanes, over its 8,192). Here the grid is the finest
    whose cells still hold 2.2 r_max, as merger_full's rule without the
    clamp: 204 cells at n = 1,048,576, where band 8 fits."""
    sc, box = scene.galaxy_merger_3d(n=n, seed=0)
    cfg = SimConfig(**MERGER_CFG).to(dev)
    r_max = float(body_radius(torch.from_numpy(sc["mass"]), torch.from_numpy(sc["mat"]),
                              SimConfig().materials).max())
    g_c = int(box / (2.2 * r_max))
    g_c = max(8, g_c - g_c % 2)
    band = 8 if g_c >= 16 else 2
    if tune is None:
        tune = p3m.p3m_tune_for(sc["pos"], box, residual_budget=131072, affected_budget=2048, k_max=1536)
    kw = dict(n_cells=g_c, band_cells=band, buckets=collide.bucketed_layout_for(sc["pos"], box, g_c, band),
              force_impl="p3m", log_events=True, pm_grid=tune["g"], p3m=tune,
              green_hat=isolated_green_hat(box, tune["g"], p3m.smoothing_length(box, tune["n_cells"]),
                                           smoothed=True, device=dev))
    st = collisions_scaled.make_granular_state(sc["pos"], sc["vel"], sc["mass"], mat=sc["mat"],
                                               temp=sc["temp"], seed=0, device=dev)
    return st, cfg, box, kw


def phase_merger(dev, n: int = MERGER_N, frames: int = 2, steps: int = 2) -> tuple[float, tuple, dict, dict]:
    st, cfg, box, kw = merger_setup(dev, n)
    tune = kw["p3m"]
    log(10, f"N={n} box={box:g}: collisions g={kw['n_cells']} B={kw['band_cells']} buckets={kw['buckets']}; "
            f"P3M tune {tune}")
    # K4 and K5 on the arguments the scene's first force evaluation gives them
    k4, k5 = pp_full_width(10, f"merger N={n}", st.pos, st.mass, cfg.G, cfg.softening, box, tune)
    st, tot, _ = collisions_scaled.granular_full_kdk_scan(st, cfg, box, steps, **kw)  # warm-up frame
    torch.cuda.synchronize()
    log(10, f"warm-up frame: n_overflow {int(tot['n_overflow'])} n_uncorrected {int(tot['n_uncorrected'])}")

    reset_pp_counts()  # the merger step's path starts here
    collide.collide_fused.launches = 0
    totals = []
    t0 = time.perf_counter()
    for _ in range(frames):
        st, tot, _ = collisions_scaled.granular_full_kdk_scan(st, cfg, box, steps, **kw)
        totals.append(tot)
    torch.cuda.synchronize()
    ms = (time.perf_counter() - t0) / (frames * steps) * 1e3
    agg = {k: torch.stack([t[k] for t in totals]) for k in totals[0]}
    evals = frames * (steps + 1)
    launches = (collide.collide_fused.launches, ppkernel.pp_short.launches, ppkernel.pp_react.launches)
    check(launches == (frames * steps * len(kw["buckets"]), 2 * evals, evals),
          f"K2, K4, K5 launches {launches} in {frames} frames of {steps} steps")
    n_ovf, n_unc = int(agg["n_overflow"].max()), int(agg["n_uncorrected"].max())
    check(n_ovf == 0, f"n_overflow {n_ovf} == 0")
    check(n_unc == 0, f"n_uncorrected {n_unc} == 0")
    check(all_finite(st.pos, st.vel, st.mass, st.temp), "state finite")
    log(10, f"N={n}, {frames} frames of {steps} steps: {ms:.3f} ms/step; bounces {int(agg['n_bounces'].sum())} "
            f"merges {int(agg['n_merges'].sum())} fractures {int(agg['n_fractures'].sum())} "
            f"dropped {int(agg['n_dropped'].sum())}; n_overflow {n_ovf} n_uncorrected {n_unc}; "
            f"launches K2 {launches[0]} K4 {launches[1]} K5 {launches[2]}; alive {int((st.mass > 0).sum())}")

    torch.cuda.set_sync_debug_mode("error")
    try:
        st, tot, _ = collisions_scaled.granular_full_kdk_scan(st, cfg, box, steps, **kw)
    finally:
        torch.cuda.set_sync_debug_mode("default")
    torch.cuda.synchronize()
    check(int(tot["n_uncorrected"]) == 0 and ppkernel.pp_react.launches == evals + steps + 1,
          "kernels ran in the sync-checked frame")
    log(10, "one frame ran under set_sync_debug_mode('error'): no host sync in the P3M granular step")
    return ms, launches, k4, k5


MERGER_SMALL_TUNE = dict(g=32, n_cells=8, max_per_cell=32, max_residual=4096, affected_cap=512)


def phase_merger_vs_cpu(dev, n: int = 4096, steps: int = 2) -> None:
    a, cfg, box, kw = merger_setup(dev, n, MERGER_SMALL_TUNE)
    b, cpu_cfg, _, kw_cpu = merger_setup("cpu", n, MERGER_SMALL_TUNE)
    tune = MERGER_SMALL_TUNE
    n_res = int(p3m.overflowing(p3m.cell_sort(b.pos, box, tune["n_cells"]), tune["max_per_cell"])[0])
    check(n_res > 0, f"the small P3M parameters overflow ({n_res} residuals)")
    gen = torch.Generator().manual_seed(4)
    draws = [draw_fracture_uniforms(cpu_cfg, gen, "cpu") for _ in range(steps)]
    reset_pp_counts()
    a, ta, ea = collisions_scaled.granular_full_kdk_scan(a, cfg, box, steps, draws=[d.to(dev) for d in draws],
                                                         **kw)
    check(ppkernel.pp_react.launches == steps + 1, "K5 ran on the card")
    b, tb, eb = collisions_scaled.granular_full_kdk_scan(b, cpu_cfg, box, steps, draws=draws, **kw_cpu)
    for k in ta:
        check(torch.equal(ta[k].cpu(), tb[k]), f"total {k} equal on card and CPU ({ta[k].tolist()} vs {tb[k].tolist()})")
    for f in ("n_merges", "n_fractures", "n_bounces", "n_overflow", "n_dropped", "merge_mask",
              "fracture_mask", "spawn_mask"):
        check(torch.equal(getattr(ea, f).cpu(), getattr(eb, f)), f"events {f} equal on card and CPU")
    check(torch.equal(a.partner.cpu(), b.partner) and torch.equal(a.mat.cpu(), b.mat),
          "partners and materials equal on card and CPU")
    for f in ("pos", "vel", "mass", "temp", "contact_t"):
        x, y = getattr(a, f).cpu(), getattr(b, f)
        err = float((x - y).abs().max()) / max(float(y.abs().max()), 1e-30)
        log(10, f"N={n}, {steps} steps card vs CPU: {f} max rel err {err:.3e} (tol {SCALED_CPU_TOL:g})")
        check(err < SCALED_CPU_TOL, f"{f} card vs CPU after {steps} steps")
    log(10, f"N={n} ({n_res} residuals at the start): totals "
            f"{{{', '.join(f'{k}: {int(v)}' for k, v in tb.items())}}} equal on card and CPU")


# ---- the gravity-only integration path: K6 and K3 --------------------------------

def rand_vel(n: int, seed: int, dev):
    """Standard normal velocities [n, 3], float32 (also the card tests')."""
    rng = np.random.default_rng(seed)
    return torch.tensor(rng.normal(size=(n, 3)), dtype=torch.float32, device=dev)


def gravity_kernel_sizes(dev, n: int, err6: float, err3: float,
                         n_targets: int | None = None) -> tuple[float, float, dict, dict]:
    """K6 and K3 against their plain versions on the drift gate's Plummer
    sphere at N = n: on every target, with the target defaults exactly as
    phases 12 and 13 call them, or on the first n_targets targets against
    all sources; then both timed at full width with their plain versions
    and bounds. Returns the errors so far and the (K6, K3) entries of the
    kernels line."""
    pos, vel, mass, G, eps, _ = drift.gate_scene(n, device=dev)
    args6, args3 = (pos, mass, vel, G, eps), (pos, mass, G, eps)
    label = f"Plummer N={n}, every target"
    if n_targets is not None:
        t = slice(0, n_targets)
        args6, args3 = args6 + (pos[t], vel[t]), args3 + (pos[t], mass[t])
        label = f"Plummer N={n}, first {n_targets} targets"
    got, want = pairwise_acc_jerk(*args6), pairwise_acc_jerk_reference(*args6)
    err6 = max(err6, compare(f"K6 {label} acc", got[0], want[0], 11),
               compare(f"K6 {label} jerk", got[1], want[1], 11))
    err3 = max(err3, compare(f"K3 {label}", potential_per_body(*args3), potential_per_body_reference(*args3), 11))
    acc, jerk = pairwise_acc_jerk(pos, mass, vel, G, eps)
    check(all_finite(acc, jerk, potential_per_body(pos, mass, G, eps)), f"K6 and K3 outputs finite at N={n}")

    out = []
    for name, fn, plain, args, ops, nbytes in (
            ("K6", pairwise_acc_jerk, pairwise_acc_jerk_reference, (pos, mass, vel, G, eps), K6_PAIR_OPS, 52),
            ("K3", potential_per_body, potential_per_body_reference, (pos, mass, G, eps), K3_PAIR_OPS, 20)):
        ms = cuda_ms(lambda: fn(*args), 5)
        plain_ms = cuda_ms(lambda: plain(*args), 1)
        b = bound(n * n * ops, n * n, n * nbytes)
        log(11, f"{name} N={n}: kernel {ms:.4f} ms ({n * n / (ms * 1e-3):.4e} pairs/s), plain {plain_ms:.3f} ms, "
                f"plain/kernel {plain_ms / ms:.2f}x; {bound_text(b)}")
        out.append(dict(ms=ms, plain_ms=plain_ms, **record(b), library_ms=None))
    return err6, err3, out[0], out[1]


def phase_gravity_kernels(dev, n_small: int = DRIFT_N, n_big: int = HEADLINE_N) -> tuple[dict, dict]:
    """K6 and K3 against their plain versions on the card: N = 4,096 random,
    1,000 targets x 4,096 sources, 777 x 3,001 ragged, mass-0 padding inert,
    K3's self term on a target slice; then the drift gate's Plummer sphere at
    N = n_small on every target and at n_big on the first 4,096, each timed.
    Returns the (K6, K3) entries of the kernels line, held and timed at
    n_small (the shapes of phases 12 and 13)."""
    G, eps = 0.5, 0.5
    err6 = err3 = 0.0

    def both6(label, *args):
        nonlocal err6
        (ga, gj), (wa, wj) = pairwise_acc_jerk(*args), pairwise_acc_jerk_reference(*args)
        err6 = max(err6, compare(f"K6 {label} acc", ga, wa, 11), compare(f"K6 {label} jerk", gj, wj, 11))

    def both3(label, *args):
        nonlocal err3
        err3 = max(err3, compare(f"K3 {label}", potential_per_body(*args), potential_per_body_reference(*args), 11))

    pos, mass = rand_bodies(4096, 0, dev)
    vel = rand_vel(4096, 10, dev)
    both6("N=4096 random", pos, mass, vel, G, eps)
    both3("N=4096 random", pos, mass, G, eps)
    tp, tv, tm = pos[37:1037], vel[37:1037], mass[37:1037]
    both6("1000 targets x 4096 sources", pos, mass, vel, G, eps, tp, tv)
    both3("1000 targets x 4096 sources", pos, mass, G, eps, tp, tm)
    # the self term removed on a target slice: the slice's potentials are the full set's
    err3 = max(err3, compare("K3 target slice vs the full set's rows", potential_per_body(pos, mass, G, eps, tp, tm),
                             potential_per_body(pos, mass, G, eps)[37:1037], 11))
    src, m_src = rand_bodies(3001, 1, dev)
    tgt, _ = rand_bodies(777, 2, dev)
    v_src, v_tgt = rand_vel(3001, 11, dev), rand_vel(777, 12, dev)
    both6("777 targets x 3001 sources (ragged)", src, m_src, v_src, G, eps, tgt, v_tgt)
    # targets that are not sources: target_mass 0 leaves the raw sum
    both3("777 targets x 3001 sources (ragged)", src, m_src, G, eps, tgt, torch.zeros(777, device=dev))
    m_pad = mass.clone()
    m_pad[2048:] = 0.0
    (ga, gj), (wa, wj) = (pairwise_acc_jerk(pos, m_pad, vel, G, eps),
                          pairwise_acc_jerk_reference(pos[:2048], mass[:2048], vel[:2048], G, eps))
    err6 = max(err6, compare("K6 mass-0 padding inert acc", ga[:2048], wa, 11),
               compare("K6 mass-0 padding inert jerk", gj[:2048], wj, 11))
    err3 = max(err3, compare("K3 mass-0 padding inert", potential_per_body(pos, m_pad, G, eps)[:2048],
                             potential_per_body_reference(pos[:2048], mass[:2048], G, eps), 11))

    err6 = accjerk_splits(dev, err6, n_small, n_big)
    err3 = potential_splits(dev, err3, n_small, n_big)
    err6, err3, k6, k3 = gravity_kernel_sizes(dev, n_small, err6, err3)
    err6, err3, _, _ = gravity_kernel_sizes(dev, n_big, err6, err3, n_targets=4096)
    k6["max_abs_err"], k3["max_abs_err"] = err6, err3
    return k6, k3


def accjerk_splits(dev, err6: float, n_small: int, n_big: int) -> float:
    """K6's source split: its grids at n_small and n_big; a shape whose last
    split is shorter (SHORT_LAST_SPLIT_N) and softening 1e-20 (eps^2 below
    FLT_MIN: the rsqrtf instantiation, targets 300 away) against the plain
    version; the drift gate's sphere at n_small twice, bitwise. Returns the
    largest error so far."""
    log(11, f"K6 at {pairwise.ACCJERK_TARGETS} targets a thread: " + "; ".join(
        f"N={n}: {grid_text(pairwise.ACCJERK_ROWS, n, n)}" for n in (n_small, SHORT_LAST_SPLIT_N, n_big)))
    G, eps = 0.5, 0.5
    n = SHORT_LAST_SPLIT_N
    pos, mass = rand_bodies(n, 13, dev)
    vel = rand_vel(n, 14, dev)
    (ga, gj), (wa, wj) = (pairwise_acc_jerk(pos, mass, vel, G, eps),
                          pairwise_acc_jerk_reference(pos, mass, vel, G, eps))
    err6 = max(err6, compare(f"K6 N={n} (shorter last split) acc", ga, wa, 11),
               compare(f"K6 N={n} (shorter last split) jerk", gj, wj, 11))
    pos, mass = rand_bodies(4096, 15, dev)
    tgt, _ = rand_bodies(1000, 16, dev)
    tgt += 300.0
    vel, tvel = rand_vel(4096, 17, dev), rand_vel(1000, 18, dev)
    args = (pos, mass, vel, G, 1e-20, tgt, tvel)
    (ga, gj), (wa, wj) = pairwise_acc_jerk(*args), pairwise_acc_jerk_reference(*args)
    check(all_finite(ga, gj), "K6 at softening 1e-20 finite")
    err6 = max(err6, compare("K6 softening 1e-20 (rsqrtf) acc", ga, wa, 11),
               compare("K6 softening 1e-20 (rsqrtf) jerk", gj, wj, 11))
    pos, vel, mass, G, eps, _ = drift.gate_scene(n_small, device=dev)
    first, second = pairwise_acc_jerk(pos, mass, vel, G, eps), pairwise_acc_jerk(pos, mass, vel, G, eps)
    check(all(torch.equal(a, b) for a, b in zip(first, second)), f"K6 at N={n_small} twice: the same bits")
    log(11, f"K6 Plummer N={n_small}: a second call gives the same bits")
    return err6


def potential_splits(dev, err3: float, n_small: int, n_big: int) -> float:
    """K3's source split: its grids at n_small and n_big; a shape whose last
    split is shorter (SHORT_LAST_SPLIT_N) and softening 1e-20 (eps^2 below
    FLT_MIN: the rsqrtf instantiation, targets 300 away, target mass 0)
    against the plain version; the drift gate's sphere at n_small twice,
    bitwise, and its self term against the wrapper's (a body's raw sum is
    -phi + G m / eps: its error against the plain version's, relative to
    G m / eps). Returns the largest error so far."""
    log(11, f"K3 at {pairwise.POTENTIAL_TARGETS} targets a thread: " + "; ".join(
        f"N={n}: {grid_text(pairwise.POTENTIAL_ROWS, n, n)}" for n in (n_small, SHORT_LAST_SPLIT_N, n_big)))
    G, eps = 0.5, 0.5
    n = SHORT_LAST_SPLIT_N
    pos, mass = rand_bodies(n, 13, dev)
    err3 = max(err3, compare(f"K3 N={n} (shorter last split)", potential_per_body(pos, mass, G, eps),
                             potential_per_body_reference(pos, mass, G, eps), 11))
    pos, mass = rand_bodies(4096, 15, dev)
    tgt, _ = rand_bodies(1000, 16, dev)
    tgt += 300.0
    zero = torch.zeros(1000, device=dev)
    got = potential_per_body(pos, mass, G, 1e-20, tgt, zero)
    check(all_finite(got), "K3 at softening 1e-20 finite")
    err3 = max(err3, compare("K3 softening 1e-20 (rsqrtf)", got,
                             potential_per_body_reference(pos, mass, G, 1e-20, tgt, zero), 11))
    pos, _, mass, G, eps, _ = drift.gate_scene(n_small, device=dev)
    first = potential_per_body(pos, mass, G, eps)
    check(torch.equal(first, potential_per_body(pos, mass, G, eps)), f"K3 at N={n_small} twice: the same bits")
    log(11, f"K3 Plummer N={n_small}: a second call gives the same bits")
    self_term = G * mass / eps
    rel = float((first - potential_per_body_reference(pos, mass, G, eps)).abs().max() / self_term.max())
    log(11, f"K3 Plummer N={n_small}: max|kernel - plain| / max(G m / eps) = {rel:.3e} "
            f"({rel * 2 ** 23:.2f} ulp of the largest self term)")
    return err3


def launches_per_step(state: integrators.PhaseState, force, h: float, steps: int, names: tuple,
                      per_step: int = 1) -> tuple[float, float, float, float]:
    """(kernels launched per compensated KDK step, wall ms per step, device
    ms per step, the force kernels' device ms per step) over one chunk of
    `steps` steps under torch.profiler: the wall and the device times are
    of the same steps. The force's kernels are those whose names hold one
    of `names`, per_step a step, their time the mean of those the profiler
    saw times per_step. A measurement: the profiler has missed a few of a
    chunk's ~1,900 kernels, and then reads the kernels and the device time a
    step low; the wrappers' `.launches` count the launches exactly."""
    cuda = torch.autograd.DeviceType.CUDA
    pc = vc = torch.zeros_like(state.pos)
    acts = [torch.profiler.ProfilerActivity.CPU, torch.profiler.ProfilerActivity.CUDA]
    with torch.profiler.profile(activities=acts) as prof:
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        for _ in range(steps):
            state, pc, vc = integrators.kdk_compensated_step(state, pc, vc, h, force)
        torch.cuda.synchronize()
        wall_ms = (time.perf_counter() - t0) / steps * 1e3
    kernels = [e for e in prof.events() if e.device_type == cuda]
    check(len(kernels) > 0, "the profiler saw the device's kernels")
    k1 = [e for e in kernels if any(name in e.name for name in names)]
    check(0 < len(k1) <= steps * per_step, f"the profiler saw {names} {len(k1)} times in {steps} steps")
    return (len(kernels) / steps, wall_ms, sum(e.time_range.elapsed_us() for e in kernels) / steps / 1e3,
            sum(e.time_range.elapsed_us() for e in k1) / len(k1) * per_step / 1e3)


def phase_drift_gate(dev, n: int = DRIFT_N, n_steps: int = 10_000, diag_every: int = 100):
    """The drift gate at nbx.bench.drift.main's configuration: Kahan-
    compensated KDK with K1 forces, the energy through K3 every diag_every
    steps. Returns the energies (on the host), the K3 launches and ms/step."""
    pos, vel, mass, G, eps, h = drift.gate_scene(n, device=dev)
    drift.drift_run(pos, vel, mass, G, eps, h, 0)  # warm-up: kernel load, allocator
    torch.cuda.synchronize()

    pairwise_acc.launches = 0  # the drift gate's path starts here
    potential_per_body.launches = 0
    t0 = time.perf_counter()
    p, v, energies = drift.drift_run(pos, vel, mass, G, eps, h, n_steps, diag_every)
    torch.cuda.synchronize()
    ms = (time.perf_counter() - t0) / n_steps * 1e3
    k1, k3 = pairwise_acc.launches, potential_per_body.launches
    check((k1, k3) == (n_steps + 1, n_steps // diag_every + 1),
          f"K1 {k1} and K3 {k3} launches in {n_steps} steps with energies every {diag_every}")
    d = drift.relative_drift(energies)
    check(all_finite(p, v, energies), "state and energies finite")
    # a measurement: K1's launches are counted exactly above; a call is two
    # launches, the split sum and combine_splits
    state = integrators.PhaseState(p, v, pairwise_acc(p, mass, G, eps))
    per_step, prof_ms, dev_ms, k1_ms = launches_per_step(
        state, lambda x: pairwise_acc(x, mass, G, eps), h, diag_every, ("pairwise_f32r", "combine_splits"), 2)
    *_, combine_ms = launches_per_step(state, lambda x: pairwise_acc(x, mass, G, eps), h, diag_every,
                                       ("combine_splits",))
    log(12, f"Plummer N={n}, h={h:.4e}, eps={eps:.4f}, {n_steps} compensated KDK steps: drift {d:.4e} "
            f"(gate {drift.GATE:g}); {ms:.4f} ms/step wall; launches K1 {k1} K3 {k3}; under torch.profiler, "
            f"{diag_every} steps: {per_step:.2f} kernels per step, {prof_ms:.4f} wall ms per step, "
            f"{dev_ms:.4f} device ms per step (busy {dev_ms / prof_ms:.3f}), K1 {k1_ms:.4f} of it "
            f"(combine_splits {combine_ms:.4f}, in a chunk of its own)")
    check(d < drift.GATE, f"relative energy drift {d} < {drift.GATE}")

    torch.cuda.set_sync_debug_mode("error")
    try:
        _, _, e = drift.drift_run(p, v, mass, G, eps, h, diag_every, diag_every)
    finally:
        torch.cuda.set_sync_debug_mode("default")
    torch.cuda.synchronize()
    check(all_finite(e), "the sync-checked chunk's energies finite")
    log(12, f"one {diag_every}-step chunk ran under set_sync_debug_mode('error'): no host sync in drift_run")
    return energies.cpu(), k3, ms


def hermite_energies(state, mass, G, eps, h, n_steps, diag_every, force_jerk):
    """run_hermite in chunks of diag_every steps, the energy through K3 after
    each; returns the final state and the energies (the first at the start)."""
    es = [drift.energy(state.pos, state.vel, mass, G, eps)]
    for _ in range(n_steps // diag_every):
        state, _ = integrators.run_hermite(state, h, diag_every, force_jerk)
        es.append(drift.energy(state.pos, state.vel, mass, G, eps))
    return state, torch.stack(es)


def phase_hermite(dev, kdk_energies: torch.Tensor, n: int = DRIFT_N, n_steps: int = 1000,
                  diag_every: int = 100) -> tuple[int, float]:
    """The 4th-order Hermite scheme with K6 on the drift gate's scene and
    step; then 10 Hermite and 10 KDK steps at N = 1,024 on the card against
    the CPU. Returns K6's launches on the Hermite path and the ms/step."""
    pos, vel, mass, G, eps, h = drift.gate_scene(n, device=dev)

    def force_jerk(p, v):
        return pairwise_acc_jerk(p, mass, v, G, eps)

    integrators.run_hermite(integrators.init_hermite(pos, vel, force_jerk), h, 1, force_jerk)  # warm-up
    torch.cuda.synchronize()

    pairwise_acc_jerk.launches = 0  # the Hermite path starts here
    t0 = time.perf_counter()
    s, es = hermite_energies(integrators.init_hermite(pos, vel, force_jerk), mass, G, eps, h, n_steps,
                             diag_every, force_jerk)
    torch.cuda.synchronize()
    ms = (time.perf_counter() - t0) / n_steps * 1e3
    k6 = pairwise_acc_jerk.launches
    check(k6 == n_steps + 1, f"K6 launched {k6} times in {n_steps} Hermite steps")
    check(all_finite(s.pos, s.vel, s.acc, s.jerk, es), "Hermite state and energies finite")
    d = drift.relative_drift(es)
    d_kdk = drift.relative_drift(kdk_energies[: n_steps // diag_every + 1])
    log(13, f"Plummer N={n}, h={h:.4e}, {n_steps} Hermite steps: drift {d:.4e} against compensated KDK's "
            f"{d_kdk:.4e} over the same {n_steps} steps; {ms:.4f} ms/step wall; K6 launches {k6}")
    check(d < drift.GATE, f"Hermite relative energy drift {d} < {drift.GATE}")

    torch.cuda.set_sync_debug_mode("error")
    try:
        s, e = hermite_energies(s, mass, G, eps, h, diag_every, diag_every, force_jerk)
    finally:
        torch.cuda.set_sync_debug_mode("default")
    torch.cuda.synchronize()
    check(all_finite(s.pos, e), "the sync-checked chunk finite")
    log(13, f"one {diag_every}-step chunk ran under set_sync_debug_mode('error'): no host sync in run_hermite")

    gravity_steps_vs_cpu(dev)
    return k6, ms


def ten_steps(device) -> tuple:
    """10 Hermite steps (K6 on the card) and 10 compensated KDK steps (K1,
    the energies through K3) from the gate's Plummer sphere at N = 1,024."""
    pos, vel, mass, G, eps, h = drift.gate_scene(1024, device=device)

    def force_jerk(p, v):
        return pairwise_acc_jerk(p, mass, v, G, eps)

    s, _ = integrators.run_hermite(integrators.init_hermite(pos, vel, force_jerk), h, 10, force_jerk)
    return (*s, *drift.drift_run(pos, vel, mass, G, eps, h, 10, diag_every=10))


def gravity_steps_vs_cpu(dev) -> None:
    names = ("Hermite pos", "Hermite vel", "Hermite acc", "Hermite jerk", "KDK pos", "KDK vel", "KDK energies")
    for name, x, y in zip(names, ten_steps(dev), ten_steps(torch.device("cpu"))):
        err = float((x.cpu() - y).abs().max()) / max(float(y.abs().max()), 1e-30)
        log(13, f"N=1024, 10 steps card vs CPU: {name} max rel err {err:.3e} (tol {SCALED_CPU_TOL:g})")
        check(err < SCALED_CPU_TOL, f"{name} card vs CPU after 10 steps")


def phase_bench(dev, latency_ns=latency.NS, n_rate: int = HEADLINE_N) -> None:
    """`bench latency` and `bench throughput` through their mains on the card."""
    lat = latency.main(ns=latency_ns, device=dev)
    check(all(0 < ms < float("inf") for ms in lat.values()), "latencies positive and finite")
    log(14, "p50 ms per KDK step: " + ", ".join(f"N={n}: {ms:.4f}" for n, ms in lat.items()))
    rate = throughput.main(n=n_rate, device=dev)
    check(rate > 0, "throughput positive")
    log(14, f"N={n_rate}: {rate:.4e} pairs/s")


# ---- the rest of the collision pass: K8 (full column), K2's other layouts, K2m ----

def record_launches(fused):
    """A kernel wrapper that also keeps the arguments of each of its calls,
    so they can be replayed (timed, or through the plain version)."""
    calls = []

    def rec(*args):
        calls.append(args)
        fused(*args)

    return rec, calls


def layout_both(inputs, box: float, g: int, kw: dict):
    """One layout's pass (binned_collision_pass's keywords kw) through its
    kernel and through its plain version. Returns (kernel outputs, plain
    outputs, the kernel wrapper, the kernel's calls)."""
    run, layout, fused = collide._layout_call(
        g, kw.get("max_per_cell", 16), kw.get("band_cells"), kw.get("packed_caps"), kw.get("max_blocks"),
        kw.get("buckets"), kw.get("windows_per_block", 1))
    rec, calls = record_launches(fused)
    got = run(*inputs, box, g, *layout, 0.2, 0.5, rec)
    want = run(*inputs, box, g, *layout, 0.2, 0.5, collide.collide_fused_reference)
    return got, want, fused, calls


def _covered(starts: torch.Tensor, counts: torch.Tensor, n: int) -> torch.Tensor:
    """[n + 1] int32 whose cumulative sum is > 0 on the rows of the ranges
    [start, start + count), in the order of n rows (ends past n are cut)."""
    starts = torch.where(counts > 0, starts, 0).clamp(0, n).reshape(-1)
    ends = (starts + counts.clamp_min(0).reshape(-1)).clamp(max=n)
    edge = torch.zeros(n + 1, dtype=torch.int32, device=starts.device)
    one = torch.ones_like(starts, dtype=torch.int32)
    return edge.index_add_(0, starts, one).index_add_(0, ends, -one)


def launch_bound(calls) -> tuple[dict, int]:
    """The bound of one pass's launches, counted from their windows: every
    target against every kept source lane of its window (the overlap test,
    K2_LANE_OPS each); each row that a window reads (its targets' feats and
    ids, its strips' feats, ids and source flags) read once, however many
    launches read it; each target's delta row and partner written once; the
    descriptors read once. Rows that no window reads (a layout's padding)
    count nothing. Returns (bound, source lanes)."""
    lanes = sum(int((w[:, 1].long() * w[:, 3::2].long().sum(1)).sum()) for _, _, _, w, *_ in calls)
    edges = {}  # feats' storage -> (target edges, source edges)
    for feats, _, _, w, *_ in calls:
        n, w = feats.shape[0], w.long()
        t, s = edges.get(feats.data_ptr(), (0, 0))
        edges[feats.data_ptr()] = (t + _covered(w[:, 0], w[:, 1], n), s + _covered(w[:, 2::2], w[:, 3::2], n))
    nbytes = sum(c[3].numel() * 4 for c in calls)
    for t, s in edges.values():
        t, s = t.cumsum(0) > 0, s.cumsum(0) > 0
        nbytes += int((t | s).sum()) * (32 + 4) + int(s.sum()) * 1 + int(t.sum()) * (32 + 4)
    return bound(lanes * K2_LANE_OPS, 0, nbytes), lanes


def time_launches(phase: int, label: str, fused, calls, plain_reps: int = 1) -> dict:
    """The recorded launches of one pass, by CUDA events, against the plain
    version on the same arguments; with their bound. The replays write into
    copies of the output buffers: the pass's outputs are views of them."""
    calls = [(*c[:4], c[4].clone(), c[5].clone(), *c[6:]) for c in calls]

    def kernel():
        for c in calls:
            fused(*c)

    def plain():
        for c in calls:
            collide.collide_fused_reference(*c)

    kernel()  # warm-up
    ms = cuda_ms(kernel, 5)
    plain_ms = cuda_ms(plain, plain_reps)
    b, lanes = launch_bound(calls)
    occupied = sum(int((c[3][:, 1] > 0).sum()) for c in calls)
    log(phase, f"{label}: kernel {ms:.4f} ms ({len(calls)} launches, {calls[0][3].shape[0]} windows in the "
               f"first, {occupied} with targets in all), plain {plain_ms:.3f} ms, plain/kernel "
               f"{plain_ms / ms:.1f}x; {lanes} source lanes, {bound_text(b)}")
    return dict(ms=ms, plain_ms=plain_ms, **record(b))


# (label, scene seed, dead bodies, radius scale, g, layout keywords); "sized"
# caps come from packed_caps_for / packed_layout_for
SMALL_LAYOUTS = [
    ("full column K=80 (covers)", 7, False, 2.0, 4, dict(max_per_cell=80)),
    ("full column K=16 (overflows)", 7, False, 2.0, 8, dict(max_per_cell=16)),
    ("full column K=16, dead bodies", 9, True, 2.0, 8, dict(max_per_cell=16)),
    ("banded B=2 K=80 (covers)", 7, False, 2.0, 4, dict(band_cells=2, max_per_cell=80)),
    ("banded B=4 K=4 (overflows)", 7, False, 2.0, 8, dict(band_cells=4, max_per_cell=4)),
    ("banded B=3 K=16, dead bodies", 9, True, 2.0, 8, dict(band_cells=3, max_per_cell=16)),
    ("band-packed sized caps (covers)", 7, False, 2.0, 8, dict(band_cells=4, packed_caps="sized")),
    ("band-packed (8, 10) (overflows)", 7, False, 2.0, 8, dict(band_cells=4, packed_caps=(8, 10))),
    ("band-packed (68, 24) (source lanes overflow)", 7, False, 2.0, 8, dict(band_cells=4, packed_caps=(68, 24))),
    ("compacted sized (covers)", 7, False, 2.0, 8, dict(band_cells=4, packed_caps="sized", max_blocks=0)),
    ("compacted budget 40 (windows dropped)", 7, False, 2.0, 8,
     dict(band_cells=4, packed_caps=(68, 70), max_blocks=40)),
    ("compacted (16, 24) x 64, dead bodies", 9, True, 2.0, 8,
     dict(band_cells=4, packed_caps=(16, 24), max_blocks=64)),
]


def small_layout(seed: int, dead: bool, g: int, kw: dict):
    pos, vel, mass = clustered_scene(seed=seed)
    if dead:
        mass[::5] = 0.0
    if kw.get("packed_caps") == "sized":
        if "max_blocks" in kw:
            lay = collide.packed_layout_for(pos, BOX, g, kw["band_cells"])
            kw = dict(kw, packed_caps=lay["packed_caps"], max_blocks=lay["max_blocks"])
        else:
            kw = dict(kw, packed_caps=collide.packed_caps_for(pos, BOX, g, kw["band_cells"]))
    return pos, vel, mass, kw


def layout_keywords(token: str, pos, box: float) -> dict:
    """binned_collision_pass's keywords of a granular-bench cfg token, sized
    on pos as the bench sizes them."""
    g, k, band, packed, max_blocks = granular.parse_config(token)
    lay, _ = granular.size_layout(pos, box, g, band, packed, max_blocks)
    return dict(max_per_cell=k, band_cells=band, packed_caps=lay["packed"], max_blocks=lay["max_blocks"],
                buckets=lay["buckets"], windows_per_block=lay["windows"])


def phase_layouts(dev, n_big: int = SCALED_N) -> tuple[dict, float]:
    """Every layout of the collision pass but the bucketed one (phase 6),
    kernel against plain version on the card: the clustered 192-body scenes
    (covering and overflowing caps, dead bodies), then the bench's debris
    disk at n_big at each of the granular bench's five configurations, each
    timed. Returns K8's kernels-line entry (timed on the disk's full-column
    configuration) and the largest error of K2's launches here."""
    err8 = err2 = 0.0
    for label, seed, dead, scale, g, kw in SMALL_LAYOUTS:
        pos, vel, mass, kw = small_layout(seed, dead, g, kw)
        got, want, fused, calls = layout_both(collide_inputs(pos, vel, mass, scale, dev), BOX, g, kw)
        err = check_collide(f"clustered n=192 g={g} {label} {kw}", got, want, phase=15)
        overflows = "covers" not in label
        check((int(got[5]) > 0) == overflows, f"{label}: n_overflow {int(got[5])} > 0 is {overflows}")
        check(int(got[4]) > 0, f"{label}: bounces found")
        if fused is collide.collide_full_column:
            err8 = max(err8, err)
        else:
            err2 = max(err2, err)

    pos, vel, mass, box = granular.scene_arrays(n_big, "disk")
    inputs = collide_inputs(pos, vel, mass, 1.0, dev)
    k8 = None
    for token in granular.DEFAULT_CONFIGS:
        kw = layout_keywords(token, pos, box)
        g = int(token.split(",")[0])
        got, want, fused, calls = layout_both(inputs, box, g, kw)
        err = check_collide(f"debris disk n={n_big} cfg {token}", got, want, phase=15)
        check(int(got[4]) > 0, f"disk {token}: bounces found")
        t = time_launches(15, f"disk n={n_big} cfg {token}", fused, calls)
        pass_ms = cuda_ms(lambda: collide.binned_collision_pass(*inputs, box, g, **kw), 3)
        log(15, f"disk n={n_big} cfg {token}: whole binned_collision_pass with the kernel {pass_ms:.3f} ms")
        if fused is collide.collide_full_column:
            err8 = max(err8, err)
            k8 = dict(t, library_ms=None)
        else:
            err2 = max(err2, err)
    k8["max_abs_err"] = err8
    return k8, err2


def phase_multi_window(dev, n: int = SCALED_N) -> tuple[dict, int]:
    """K2m: the bucketed pass of phase 7's 131,072-body cloud at W = 2, 4 and
    8 windows a block, bitwise against W = 1, W = 4 against the plain
    version, each timed; then the granular bench's `u0.8x4` configuration
    on that cloud (its path: the launches counted from 0 there). Returns
    K2m's kernels-line entry (at W = 4) and its launches on its path."""
    pos, vel, mass = granular_cloud(n, seed=0, box=BOX)
    buckets = collide.bucketed_layout_for(pos, BOX, 40, 12)
    inputs = collide_inputs(pos, vel, mass, 1.0, dev)
    base, want, fused1, calls = layout_both(inputs, BOX, 40, dict(band_cells=12, buckets=buckets))
    check(fused1 is collide.collide_fused, "W = 1 runs collide_fused")
    t1 = time_launches(16, f"cloud n={n} W=1 (K2)", fused1, calls)
    out = None
    for w in (2, 4, 8):
        got, plain, fused, calls_w = layout_both(inputs, BOX, 40, dict(band_cells=12, buckets=buckets,
                                                                       windows_per_block=w))
        same = all(torch.equal(a, b) for a, b in zip(got[:3], base[:3]))
        same = same and all(torch.equal(got[3][k], base[3][k]) for k in base[3])
        same = same and all(int(a) == int(b) for a, b in zip(got[4:], base[4:]))
        check(same, f"W={w}: every output bitwise equal to W=1's")
        log(16, f"cloud n={n} W={w}: every output bitwise equal to W=1's")
        t = time_launches(16, f"cloud n={n} W={w} (K2m)", fused, calls_w)
        if w == 4:
            err = check_collide(f"cloud n={n} W=4 against the plain version", got, plain, phase=16)
            out = dict(t, max_abs_err=err, library_ms=None)
    log(16, f"W=4 / W=1 kernel time {out['ms'] / t1['ms']:.3f}")

    collide.collide_fused_multi.launches = 0  # K2m's path: the bench's multi-window configuration
    rows = granular.main(n, "cloud", "pm", "40,16,12,u0.8x4", device=dev)
    launches = collide.collide_fused_multi.launches
    check(len(rows) == 1 and "ms_per_step" in rows[0], "the u0.8x4 configuration ran")
    check(launches == 24 * len(rows[0]["buckets"]), f"K2m launched {launches} times in 24 steps")
    log(16, f"bench granular {n} cloud pm 40,16,12,u0.8x4: {rows[0]['ms_per_step']:.4f} ms/step, "
            f"n_overflow {rows[0]['n_overflow']}, K2m launches {launches}")
    return out, launches


def phase_layout_benches(dev) -> int:
    """The granular bench and the collision split at their defaults (131,072
    bodies, five layouts, PM 128^3; 262,144 bodies, two layouts), the demo's
    configuration, and 3 steps of the default full-column scan at N = 4,096
    against the CPU. Returns K8's launches on the bench's path."""
    collide.collide_fused.launches = 0  # the layout bench's path
    collide.collide_full_column.launches = 0
    rows = granular.main(device=dev)
    k8, k2 = collide.collide_full_column.launches, collide.collide_fused.launches
    check(all("ms_per_step" in r for r in rows) and len(rows) == len(granular.DEFAULT_CONFIGS),
          "every default configuration timed")
    check(all(0 < r["ms_per_step"] < float("inf") for r in rows), "ms/step positive and finite")
    check(k8 == 24 and k2 == 4 * 24, f"K8 {k8} and K2 {k2} launches in 5 configurations of 24 steps")
    for r in rows:
        log(17, f"bench granular {r['n']} {r['scene']} {r['force']} g={r['n_cells']} K={r['max_per_cell']} "
                f"B={r['band_cells']} packed={r['packed_caps']}: {r['ms_per_step']:.4f} ms/step; "
                f"n_overflow {r['n_overflow']} bounces {r['n_bounces']} merges {r['n_merges']} "
                f"fractures {r['n_fractures']} cell_too_small {r['cell_too_small']}")
    for r in collsplit.main(device=dev):
        log(17, f"bench collsplit {r['n']} cfg {r['cfg']}: sort {r['ms_sort']:.4f}, pass {r['ms_pass']:.4f}, "
                f"full {r['ms_full']:.4f} ms; layout+kernel+epilogue {r['ms_layout_kernel_epilogue']:.4f}, "
                f"events {r['ms_event_machinery']:.4f}")
    phase_demo(dev)
    default_scan_vs_cpu(dev)
    return k8


def phase_demo(dev, frames: int = 20) -> float:
    """examples/granular_demo.py's physics at its N: 32,768 bodies around the
    hot m = 2000 core, g = 28, K = 12, B = 6, force "auto" (K1), 4 steps a
    frame; one more frame under set_sync_debug_mode("error")."""
    st = granular.demo_state(device=dev)
    cfg = granular.bench_config().to(dev)
    spf = granular.DEMO_STEPS_PER_FRAME
    st, _ = collisions_scaled.granular_full_kdk_scan(st, cfg, BOX, spf, **granular.DEMO_LAYOUT)  # warm-up
    torch.cuda.synchronize()
    pairwise_acc.launches = 0  # the demo's path
    collide.collide_fused.launches = 0
    totals = []
    t0 = time.perf_counter()
    for _ in range(frames):
        st, tot = collisions_scaled.granular_full_kdk_scan(st, cfg, BOX, spf, **granular.DEMO_LAYOUT)
        totals.append(tot)
    torch.cuda.synchronize()
    ms = (time.perf_counter() - t0) / frames * 1e3
    k1, k2 = pairwise_acc.launches, collide.collide_fused.launches
    check(k1 == frames * (spf + 1) and k2 == frames * spf, f"K1 {k1} and K2 {k2} launches in {frames} frames")
    check(all_finite(st.pos, st.vel, st.mass, st.temp), "state finite")
    agg = {k: torch.stack([t[k] for t in totals]) for k in totals[0]}
    log(17, f"demo N={st.pos.shape[0]} g=28 K=12 B=6 auto, {frames} frames of {spf} steps: {ms:.3f} ms/frame "
            f"({ms / spf:.3f} ms/step); bounces {int(agg['n_bounces'].sum())} merges {int(agg['n_merges'].sum())} "
            f"fractures {int(agg['n_fractures'].sum())} n_overflow max {int(agg['n_overflow'].max())} "
            f"cell_too_small {bool(agg['cell_too_small'].any())} (the core); alive {int((st.mass > 0).sum())}; "
            f"launches K1 {k1} K2 {k2}")
    torch.cuda.set_sync_debug_mode("error")
    try:
        st, _ = collisions_scaled.granular_full_kdk_scan(st, cfg, BOX, spf, **granular.DEMO_LAYOUT)
    finally:
        torch.cuda.set_sync_debug_mode("default")
    torch.cuda.synchronize()
    check(collide.collide_fused.launches == (frames + 1) * spf, "K2 ran in the sync-checked frame")
    log(17, "one demo frame ran under set_sync_debug_mode('error'): no host sync")
    return ms


def default_scan_vs_cpu(dev, n: int = 4096, steps: int = 3) -> None:
    """granular_full_kdk_scan with every default (full columns, 16 bodies a
    cell, g = 32, force "auto") on the card and on the CPU, the cloud at the
    131,072-body cloud's density, the same draws."""
    pos, vel, mass, box = granular.scene_arrays(n, "cloudcd")
    cpu_cfg = granular.bench_config()
    gen = torch.Generator().manual_seed(5)
    draws = [draw_fracture_uniforms(cpu_cfg, gen, "cpu") for _ in range(steps)]
    collide.collide_full_column.launches = 0
    a, ta, ea = collisions_scaled.granular_full_kdk_scan(
        collisions_scaled.make_granular_state(pos, vel, mass, seed=0, device=dev), cpu_cfg.to(dev), box, steps,
        draws=[d.to(dev) for d in draws], log_events=True)
    check(collide.collide_full_column.launches == steps, "K8 ran on the card")
    b, tb, eb = collisions_scaled.granular_full_kdk_scan(
        collisions_scaled.make_granular_state(pos, vel, mass, seed=0, device="cpu"), cpu_cfg, box, steps,
        draws=draws, log_events=True)
    for k in ta:
        check(torch.equal(ta[k].cpu(), tb[k]), f"total {k} equal on card and CPU ({ta[k].tolist()} vs {tb[k].tolist()})")
    for f in ("n_merges", "n_fractures", "n_bounces", "n_overflow", "n_dropped", "merge_mask",
              "fracture_mask", "spawn_mask"):
        check(torch.equal(getattr(ea, f).cpu(), getattr(eb, f)), f"events {f} equal on card and CPU")
    check(torch.equal(a.partner.cpu(), b.partner) and torch.equal(a.mat.cpu(), b.mat),
          "partners and materials equal on card and CPU")
    for f in ("pos", "vel", "mass", "temp", "contact_t"):
        x, y = getattr(a, f).cpu(), getattr(b, f)
        err = float((x - y).abs().max()) / max(float(y.abs().max()), 1e-30)
        log(17, f"N={n} default scan, {steps} steps card vs CPU: {f} max rel err {err:.3e} (tol {SCALED_CPU_TOL:g})")
        check(err < SCALED_CPU_TOL, f"{f} card vs CPU after {steps} steps")
    check(int(tb["n_bounces"]) > 0, "bounces fired")
    log(17, f"N={n} default scan: totals {{{', '.join(f'{k}: {int(v)}' for k, v in tb.items())}}} equal on card "
            "and CPU")


# ---- the spatial halo-exchange step: K7 --------------------------------------------

SPATIAL_CFG = "32,8,96,104"  # bench spatial's default g, B, Tc, Sc
SLAB_TOL = 1e-5  # D slabs' union against the whole grid: float32 sums in another order


def slab_rows(pos, box: float, g: int, d_x: int, d_y: int, me_x: int, me_y: int, junk: int = 0):
    """One virtual slab's local rows, by indexing: the bodies of its owned
    columns, then those of the boundary layers its neighbours would send (the
    rest of its local grid; every one, as a halo cap that holds them all),
    then `junk` rows outside the grid (parked by the sort). Cells as
    `cell_sort_slabgrid` computes them. Returns (rows, the number of owned
    rows, the slab's (x0_cell, slab_x, y0_cell, slab_y))."""
    two_d = d_y > 1
    w_x, w_y = g // d_x, g // d_y
    h = torch.full((), f32(box / g), dtype=torch.float32, device=pos.device)
    c = (pos[:, :2] / h).to(torch.int32).clamp(0, g - 1)
    lx = c[:, 0] - (me_x * w_x - 1)
    ly = c[:, 1] - (me_y * w_y - 1) if two_d else torch.ones_like(lx)
    in_grid = (lx >= 0) & (lx < w_x + 2) & (ly >= 0) & (ly < (w_y + 2 if two_d else 3))
    owned = (lx >= 1) & (lx <= w_x) & (ly >= 1) & (ly <= (w_y if two_d else 1))
    rows = [owned.nonzero()[:, 0], (in_grid & ~owned).nonzero()[:, 0], (~in_grid).nonzero()[:junk, 0]]
    return torch.cat(rows), rows[0].shape[0], (me_x * w_x - 1, w_x, me_y * w_y - 1 if two_d else 0,
                                               w_y if two_d else None)


def local_both(inputs, rows, box: float, g: int, b: int, caps, slab, sg, layout: str = "packed"):
    """One slab's local pass through K7 (with short gravity sg; K2 without),
    through the plain version, and through K2 on the same windows. Returns
    (kernel outputs, plain outputs, K2's outputs, the kernel's calls, K2's
    calls)."""
    p, v, m, r = (x[rows] for x in inputs)
    x0, w_x, y0, w_y = slab
    if layout == "packed":
        buckets, src_over = ((*caps, w_x * (w_y or g) * -(-g // b)),), "own_all"
    else:
        buckets, src_over = caps, "own"
    args = (p, v, m, r, box, g, b, buckets, src_over, 0.2, 0.5, x0, w_x, y0, w_y)
    rec, calls = record_launches(collide.collide_fused_grav if sg is not None else collide.collide_fused)
    got = collide._local_pass(*args, sg, fused=rec)
    want = collide._local_pass(*args, sg, fused=collide.collide_fused_reference)
    rec2, calls2 = record_launches(collide.collide_fused)
    k2 = collide._local_pass(*args, None, fused=rec2)
    return got, want, k2, calls, calls2


DELTA_FIELDS = ("dvx", "dvy", "dvz", "dpx", "dpy", "dpz", "heat")  # out_d's columns before the bounces


def check_rows(name: str, got, want) -> tuple[float, float]:
    """A body-order pass (out_d, out_j, [out_g,] n_overflow) against its
    plain version: deltas to KERNEL_TOL of each column's largest magnitude;
    bounces, partners and n_overflow exactly. Returns (max |kernel - plain|,
    the worst relative error) of the deltas."""
    err, worst = 0.0, 0.0
    for i, field in enumerate(DELTA_FIELDS):
        abs_err = float((got[0][:, i] - want[0][:, i]).abs().max())
        rel = abs_err / max(float(want[0][:, i].abs().max()), 1e-30)
        check(rel < KERNEL_TOL, f"{name} {field}: relative error {rel} >= {KERNEL_TOL}")
        err, worst = max(err, abs_err), max(worst, rel)
    check(torch.equal(got[0][:, 7], want[0][:, 7]), f"{name}: bounces equal")
    check(torch.equal(got[1], want[1]), f"{name}: partners equal")
    check(int(got[-1]) == int(want[-1]), f"{name}: n_overflow equal ({int(got[-1])} vs {int(want[-1])})")
    return err, worst


def check_local(name: str, got, want, k2, phase: int = 18) -> float:
    """K7 against its plain version (check_rows, and the gravity to
    KERNEL_TOL), and its collision outputs bitwise K2's on the same
    windows."""
    err, worst = check_rows(name, got, want)
    log(phase, f"{name} deltas, each column to its own max|plain|: max|kernel-plain|={err:.3e}, worst rel "
               f"{worst:.3e} (tol {KERNEL_TOL:g})")
    if len(got) == 4:
        err = max(err, compare(f"{name} grav", got[2], want[2], phase=phase))
        check(float(want[2].abs().max()) > 0, f"{name}: gravity found")
    same = torch.equal(got[0], k2[0]) and torch.equal(got[1], k2[1]) and int(got[-1]) == int(k2[-1])
    check(same, f"{name}: K7's deltas, partners and n_overflow bitwise K2's on the same windows")
    log(phase, f"{name}: partners equal ({int((got[1] >= 0).sum())} bodies with one), bounces "
               f"{int(got[0][:, 7].sum())}, n_overflow {int(got[-1])}; K7's collision outputs bitwise K2's")
    return err


def time_local(phase: int, label: str, calls, calls2, n: int) -> dict:
    """K7's launches of one pass and K2's on the same windows, by CUDA
    events, against K7's plain version; K7's bound from the run's lanes
    (each target against every kept lane of its window's strips)."""
    calls = [(*c[:4], c[4].clone(), c[5].clone(), *c[6:10], c[10], c[11].clone()) for c in calls]
    calls2 = [(*c[:4], c[4].clone(), c[5].clone(), *c[6:]) for c in calls2]

    def run(fn, cs):
        for c in cs:
            fn(*c)

    run(collide.collide_fused_grav, calls)  # warm-up
    ms = cuda_ms(lambda: run(collide.collide_fused_grav, calls), 5)
    ms2 = cuda_ms(lambda: run(collide.collide_fused, calls2), 5)
    ms_again = cuda_ms(lambda: run(collide.collide_fused_grav, calls), 5)
    plain_ms = cuda_ms(lambda: run(collide.collide_fused_reference, calls), 1)
    lanes = sum(int((c[3][:, 1].long() * c[3][:, 3::2].long().sum(1)).sum()) for c in calls)
    nbytes = n * (32 + 4 + 1 + 32 + 4 + 12) + sum(c[3].numel() * 4 for c in calls)
    b = bound(lanes * K7_LANE_OPS, lanes * K7_LANE_SFU, nbytes)
    log(phase, f"{label}: K7 {ms:.4f} / {ms_again:.4f} ms, K2 on the same windows {ms2:.4f} ms (K7/K2 "
               f"{ms / ms2:.2f}x), K7 plain {plain_ms:.3f} ms; {lanes} source lanes, {bound_text(b)}")
    return dict(ms=ms, plain_ms=plain_ms, k2_ms=ms2, **record(b))


# (label, seed, dead bodies, radius scale, slab (d_x, d_y, me_x, me_y), layout,
# caps: "sized" = packed_caps_for / bucketed_layout_for on the scene, or given)
SMALL_GRAV = [
    ("1-D first slab, packed, sized caps (covers)", 7, False, 2.0, (4, 1, 0, 0), "packed", "sized"),
    ("1-D inner slab, packed (8, 10) (overflows)", 7, False, 2.0, (4, 1, 1, 0), "packed", (8, 10)),
    ("1-D inner slab, packed, dead bodies", 9, True, 2.0, (4, 1, 1, 0), "packed", "sized"),
    ("2-D slab, bucketed, sized (covers)", 7, False, 2.0, (2, 4, 0, 1), "bucketed", "sized"),
    ("2-D slab, bucketed, tiny budgets (overflows)", 8, False, 4.0, (2, 4, 0, 1), "bucketed",
     ((8, 10, 4), (24, 40, 2))),
    ("whole grid (D = 1), packed, dead bodies", 9, True, 2.0, (1, 1, 0, 0), "packed", "sized"),
]


def phase_grav_kernel(dev, n_big: int = SCALED_N, n_slabs: int = 4) -> dict:
    """K7 against its plain version on the card: the clustered 192-body
    scenes as slabs of 1-D and 2-D meshes (caps that cover and overflow, dead
    bodies), at eps = 0.5 and at eps = 0 (the law's rsqrtf instantiation),
    then the 131,072-body cloud's local grids at bench spatial's
    32,8,96,104: D = 1 (the whole grid, no halo; at eps = 0 too) and
    n_slabs virtual slabs on this one card; K7's collision outputs bitwise
    K2's on the same windows throughout; at zero-overflow caps
    (packed_caps_for) the slabs' union equal to D = 1. Times K7 and K2 on
    D = 1's windows. Returns K7's kernels-line entry (without its
    launches)."""
    g8 = 8
    err = 0.0
    for eps in (0.5, 0.0):
        sg = (0.5, BOX / g8 / 3.0, eps)
        for label, seed, dead, scale, (d_x, d_y, me_x, me_y), layout, caps in SMALL_GRAV:
            pos, vel, mass = clustered_scene(seed=seed)
            if dead:
                mass[::5] = 0.0
            if caps == "sized":
                caps = (collide.packed_caps_for(pos, BOX, g8, 2) if layout == "packed" else
                        tuple((t, s_, 64) for t, s_, _ in collide.bucketed_layout_for(pos, BOX, g8, 2, 0.6)))
            inputs = collide_inputs(pos, vel, mass, scale, dev)
            rows, _, slab = slab_rows(inputs[0], BOX, g8, d_x, d_y, me_x, me_y, junk=8)
            got, want, k2, _, _ = local_both(inputs, rows, BOX, g8, 2, caps, slab, sg, layout)
            err = max(err, check_local(f"clustered n=192 eps={eps} {label} caps {caps}", got, want, k2))
            check((int(got[-1]) > 0) == ("overflows" in label), f"{label}: n_overflow {int(got[-1])}")

    g, b, tc, sc_ = (int(x) for x in SPATIAL_CFG.split(","))
    pos, vel, mass = granular_cloud(n_big, seed=0, box=BOX)
    inputs = collide_inputs(pos, vel, mass, 1.0, dev)
    every = torch.arange(n_big, device=dev)
    whole = (-1, g, 0, None)
    got, want, k2, _, _ = local_both(inputs, every, BOX, g, b, (tc, sc_), whole, (0.5, BOX / g / 3.0, 0.0))
    err = max(err, check_local(f"cloud n={n_big} D=1 eps=0.0", got, want, k2))
    sg = (0.5, BOX / g / 3.0, 0.5)
    got, want, k2, calls, calls2 = local_both(inputs, every, BOX, g, b, (tc, sc_), whole, sg)
    err = max(err, check_local(f"cloud n={n_big} D=1 caps ({tc}, {sc_})", got, want, k2))
    t = time_local(18, f"cloud n={n_big} D=1 {SPATIAL_CFG}", calls, calls2, n_big)
    for d in range(n_slabs):
        rows, _, slab = slab_rows(inputs[0], BOX, g, n_slabs, 1, d, 0)
        got, want, k2, _, _ = local_both(inputs, rows, BOX, g, b, (tc, sc_), slab, sg)
        err = max(err, check_local(f"cloud n={n_big} slab {d} of {n_slabs} ({rows.shape[0]} rows)", got, want, k2))

    caps = collide.packed_caps_for(pos, BOX, g, b)  # zero overflow
    w_d, w_j, w_g, w_o = collide.packed_collision_blocks_local(*inputs, BOX, g, b, caps, 0.2, 0.5, -1, g,
                                                               short_gravity=sg)
    check(int(w_o) == 0, "D = 1 at packed_caps_for: no overflow")
    u_d, u_j, u_g = torch.zeros_like(w_d), torch.full_like(w_j, -1), torch.zeros_like(w_g)
    n_ovf = 0
    for d in range(n_slabs):
        rows, n_own, (x0, w_x, _, _) = slab_rows(inputs[0], BOX, g, n_slabs, 1, d, 0)
        o_d, o_j, o_g, o = collide.packed_collision_blocks_local(*(x[rows] for x in inputs), BOX, g, b, caps, 0.2,
                                                                 0.5, x0, w_x, short_gravity=sg)
        own = rows[:n_own]
        u_d[own], u_g[own] = o_d[:n_own], o_g[:n_own]
        u_j[own] = torch.where(o_j[:n_own] >= 0, rows[o_j[:n_own].long().clamp(min=0)].to(torch.int32), -1)
        n_ovf += int(o)
    check(n_ovf == 0, f"{n_slabs} slabs at packed_caps_for {caps}: no overflow")
    check(torch.equal(u_j, w_j), f"{n_slabs} slabs' partners equal D = 1's")
    check(torch.equal(u_d[:, 7], w_d[:, 7]), f"{n_slabs} slabs' bounces equal D = 1's")
    for name, a, b_ in (("deltas", u_d[:, :7], w_d[:, :7]), ("grav", u_g, w_g)):
        rel = float((a - b_).abs().max()) / max(float(b_.abs().max()), 1e-30)
        log(18, f"cloud n={n_big}: {n_slabs} slabs' union against D = 1 at caps {caps}: {name} rel {rel:.3e} "
                f"(tol {SLAB_TOL:g})")
        check(rel < SLAB_TOL, f"{n_slabs} slabs' {name} equal D = 1's")
    log(18, f"cloud n={n_big}: partners ({int((w_j >= 0).sum())} bodies with one) and bounces "
            f"({int(w_d[:, 7].sum())}) of the {n_slabs} slabs equal D = 1's")
    return dict(max_abs_err=err, ms=t["ms"], plain_ms=t["plain_ms"], bound_ms=t["bound_ms"],
                bound_by=t["bound_by"], library_ms=None, k2_ms=t["k2_ms"])


def spatial_setup(dev, n: int = SCALED_N, token: str = SPATIAL_CFG, force: str = "pm", buckets=None,
                  mesh=None):
    """bench spatial's scene and step at world size 1 on `dev`: (step,
    state, cfg, h). mesh defaults to a mesh of the world on dev's type."""
    g, b, caps = spatial_bench.parse_config(token)
    box = BOX * (n / SCALED_N) ** (1.0 / 3.0)
    pos, vel, mass = granular_cloud(n, seed=0, box=box)
    cfg = granular.bench_config().to(dev)
    mesh = mesh or shard.make_mesh(device_type=torch.device(dev).type)
    if buckets == "sized":
        buckets = spatial.spatial_buckets_for(mesh, pos, box, g, b)
    halo_cap, mig_cap = spatial_bench.spatial_caps(n, g)
    pm_grid = spatial_bench.PM_GRID if n == SCALED_N else max(64, 3 * g)  # p3m needs pm_grid >= 3 g
    step = spatial.make_spatial_granular_step(mesh, cfg, box, g, b, caps, halo_cap=halo_cap, mig_cap=mig_cap,
                                              force_impl=force, pm_grid=pm_grid, buckets=buckets)
    return step, spatial.spatial_state_for(mesh, pos, vel, mass, box, g), cfg, cfg.dt, buckets


def spatial_run(dev, label: str, force: str, buckets=None, steps: int = 20, n: int = SCALED_N):
    """bench spatial's scene at world size 1: 2 warm-up steps, then `steps`
    steps, host-timed to a synchronise. Returns (ms/step, the final state,
    the summed counters, the buckets)."""
    step, st, cfg, h, buckets = spatial_setup(dev, n=n, force=force, buckets=buckets)
    m0 = float(st.mass.double().sum())
    for _ in range(2):
        st, _ = step(st, h)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    cs = []
    for _ in range(steps):
        st, c = step(st, h)
        cs.append(c)
    torch.cuda.synchronize()
    ms = (time.perf_counter() - t0) / steps * 1e3
    tot = {k: (bool(torch.stack([c[k] for c in cs]).any()) if k == "cell_too_small"
               else int(torch.stack([c[k] for c in cs]).sum())) for k in cs[0]}
    check(all_finite(st.pos, st.vel, st.acc, st.mass, st.temp, st.contact_t), f"{label}: state finite")
    m1 = float(st.mass.double().sum())
    if tot["n_dropped"] == 0:
        check(abs(m1 - m0) <= 1e-5 * m0, f"{label}: mass conserved ({m0} -> {m1})")
    log(19, f"{label}: {ms:.3f} ms/step over {steps} steps; counters summed {tot}; mass {m0:.6f} -> {m1:.6f}; "
            f"alive {int((st.mass > 0).sum())}; buckets {buckets}")
    return ms, st, tot, buckets


def phase_spatial(dev, steps: int = 20, n: int = SCALED_N, n_cpu: int = 4096, cpu_steps: int = 3) -> int:
    """The spatial step on the card at world size 1 (a process group of this
    process alone: gloo for CPU tensors, NCCL for the card's): bench
    spatial's scene with pm, with p3m (K7's path: its launches counted from
    0 there) and with spatial_buckets_for buckets, `steps` steps each; one
    p3m step under set_sync_debug_mode("error"); then cpu_steps steps at
    N = n_cpu on the card and on the CPU with the same draws: counters and
    partners exactly, floats to SCALED_CPU_TOL. Returns K7's launches on
    the p3m path."""
    before = collide.collide_fused.launches
    spatial_run(dev, "spatial pm", "pm", steps=steps, n=n)
    check(collide.collide_fused.launches - before == steps + 2, "pm: K2 launched once a step")
    collide.collide_fused_grav.launches = 0  # K7's path: the spatial step with p3m
    _, st, _, _ = spatial_run(dev, "spatial p3m", "p3m", steps=steps, n=n)
    k7 = collide.collide_fused_grav.launches
    check(k7 == steps + 2, f"p3m: K7 launched {k7} times in {steps + 2} steps")
    before = collide.collide_fused.launches
    _, _, _, buckets = spatial_run(dev, "spatial pm, bucketed", "pm", buckets="sized", steps=steps, n=n)
    check(collide.collide_fused.launches - before == (steps + 2) * len(buckets), "bucketed: K2 a bucket a step")

    step, _, cfg, h, _ = spatial_setup(dev, n=n, force="p3m")
    torch.cuda.synchronize()
    before = collide.collide_fused_grav.launches
    torch.cuda.set_sync_debug_mode("error")
    try:
        st, c = step(st, h)
    finally:
        torch.cuda.set_sync_debug_mode("default")
    torch.cuda.synchronize()
    check(collide.collide_fused_grav.launches - before == 1, "K7 ran in the sync-checked step")
    log(19, "one p3m spatial step ran under set_sync_debug_mode('error'): no host sync")
    collide.collide_fused_grav.launches = k7

    # the card against the CPU, one process: a CUDA mesh and a CPU mesh
    cuda_mesh = shard.make_mesh(device_type="cuda")
    cpu_mesh = shard.make_mesh(device_type="cpu")
    for force in ("pm", "p3m"):
        step_a, a, cfg_a, h, _ = spatial_setup(dev, n=n_cpu, token="16,4,96,104", force=force, mesh=cuda_mesh)
        step_b, b, cfg_b, _, _ = spatial_setup("cpu", n=n_cpu, token="16,4,96,104", force=force, mesh=cpu_mesh)
        gen = torch.Generator().manual_seed(11)
        for i in range(cpu_steps):
            draws = draw_fracture_uniforms(cfg_b, gen, "cpu")
            a, ca = step_a(a, h, draws.to(dev))
            b, cb = step_b(b, h, draws)
            for k in ca:
                check(bool((ca[k].cpu() == cb[k]).all()), f"{force} step {i}: {k} equal on card and CPU "
                                                          f"({ca[k].tolist()} vs {cb[k].tolist()})")
        for f in ("uid", "partner_uid", "mat", "uid_next"):
            check(torch.equal(getattr(a, f).cpu(), getattr(b, f)), f"{force}: {f} equal on card and CPU")
        for f in ("pos", "vel", "acc", "mass", "temp", "contact_t"):
            x, y = getattr(a, f).cpu(), getattr(b, f)
            err = float((x - y).abs().max()) / max(float(y.abs().max()), 1e-30)
            log(19, f"N={n_cpu} {force}, {cpu_steps} spatial steps card vs CPU: {f} max rel err {err:.3e} "
                    f"(tol {SCALED_CPU_TOL:g})")
            check(err < SCALED_CPU_TOL, f"{force}: {f} card vs CPU after {cpu_steps} steps")
        log(19, f"N={n_cpu} {force}: last counters {{{', '.join(f'{k}: {int(v)}' for k, v in cb.items())}}} "
                "equal on card and CPU")
    return k7


def phase_spatial_bench(dev) -> list:
    """`bench spatial` through its main at its defaults (131,072-body cloud,
    32,8,96,104, pm, PM 128^3); returns its two records."""
    ref, rec = spatial_bench.main(device=dev)
    check(0 < ref["ms_per_step"] < float("inf") and 0 < rec["ms_per_step"] < float("inf"), "both paths timed")
    log(20, f"bench spatial {rec['n']} {rec['g']},{rec['band']},{rec['caps']} {rec['force']} d={rec['d']}: "
            f"single scan {ref['ms_per_step']:.4f} ms/step, spatial step {rec['ms_per_step']:.4f} ms/step, "
            f"overhead_vs_single {rec['overhead_vs_single']:.4f}; last step's counters {rec['counters']}")
    return [ref, rec]


# ---- the all-gather paths (parallel.shard): K2 through the column-slab entry --------

def slab_both(inputs, box: float, g: int, b: int, caps, col_lo: int, n_cols: int):
    """One column slab's pass through its kernel and through its plain
    version: (kernel outputs, plain outputs, the kernel's calls)."""
    rec, calls = record_launches(collide.collide_fused_slab)
    args = (*inputs, box, g, b, caps, 0.2, 0.5, col_lo, n_cols)
    got = collide.packed_collision_blocks_slab(*args, fused=rec)
    want = collide.packed_collision_blocks_slab(*args, fused=collide.collide_fused_reference)
    return got, want, calls


def slab_union(parts):
    """The rows of a split's slabs reduced as the all-gather paths reduce
    them: deltas summed, partners by their largest; n_overflow summed."""
    u_d = torch.stack([p[0] for p in parts]).sum(0)
    u_j = torch.stack([p[1] for p in parts]).amax(0)
    return u_d, u_j, sum(int(p[2]) for p in parts)


def union_is_whole(u_d, u_j, whole) -> bool:
    """A split's reduced rows bitwise the whole-grid pass's outputs."""
    return (torch.equal(u_d[:, 0:3], whole[0]) and torch.equal(u_d[:, 3:6], whole[1])
            and torch.equal(u_d[:, 6], whole[2]) and torch.equal(u_j, whole[3]["j"])
            and int(u_d[:, 7].sum()) // 2 == int(whole[4]))


# (label, scene seed, dead bodies, radius scale, caps: "sized" = packed_caps_for, or given)
SMALL_SLABS = [
    ("sized caps (covers)", 7, False, 2.0, "sized"),
    ("(8, 10) (overflows)", 7, False, 2.0, (8, 10)),
    ("(68, 24) (overflows: source lanes)", 7, False, 2.0, (68, 24)),
    ("dead bodies, sized caps (covers)", 9, True, 2.0, "sized"),
]


def phase_slab_kernel(dev, n_big: int = SCALED_N, n_slabs: int = 4) -> dict:
    """K2 through the column-slab entry against its plain version on the
    card: the clustered 192-body scenes (g = 8, B = 4) as 2, 4 and 8 slabs
    (caps that cover and overflow, dead bodies), each split's reduced rows
    bitwise the whole-grid band-packed pass (K2 through binned_collision_pass)
    and its n_overflow the whole grid's; then bench spatial's 131,072-body
    cloud at 32,8,96,104 as 1 slab (D = 1, the shape phase 24's pm path gives
    the kernel) and as n_slabs slabs on this one card, their n_overflow summing
    to the whole grid's, and at packed_caps_for caps their reduced rows
    bitwise the whole grid's. Times the 1 slab's launch, the n_slabs slabs'
    and the whole-grid pass's. Returns collide_fused_slab's kernels-line
    entry (without its launches)."""
    g8, b8 = 8, 4
    err = 0.0
    for label, seed, dead, scale, caps in SMALL_SLABS:
        pos, vel, mass = clustered_scene(seed=seed)
        if dead:
            mass[::5] = 0.0
        if caps == "sized":
            caps = collide.packed_caps_for(pos, BOX, g8, b8)
        inputs = collide_inputs(pos, vel, mass, scale, dev)
        whole = collide.binned_collision_pass(*inputs, BOX, g8, band_cells=b8, packed_caps=caps)
        for d in (2, 4, 8):
            k = g8 * g8 // d
            parts, worst = [], 0.0
            for s_ in range(d):
                got, want, _ = slab_both(inputs, BOX, g8, b8, caps, s_ * k, k)
                e, rel = check_rows(f"clustered n=192 {label} caps {caps}, slab {s_} of {d}", got, want)
                err, worst = max(err, e), max(worst, rel)
                parts.append(got)
            u_d, u_j, ovf = slab_union(parts)
            check(ovf == int(whole[5]), f"{label}, {d} slabs: n_overflow {ovf} sums to the whole grid's {int(whole[5])}")
            check((ovf > 0) == ("overflows" in label), f"{label}: n_overflow {ovf} > 0 is {'overflows' in label}")
            check(union_is_whole(u_d, u_j, whole), f"{label}, {d} slabs: the reduced rows bitwise the whole grid's")
            log(21, f"clustered n=192 g=8 B=4 {label} caps {caps}, {d} slabs: kernel vs plain worst rel {worst:.3e} "
                    f"(tol {KERNEL_TOL:g}), partners and counters equal; reduced rows bitwise the whole-grid pass "
                    f"({int((u_j >= 0).sum())} partners, {int(whole[4])} bounces), n_overflow {ovf}")

    g, b, tc, sc_ = (int(x) for x in SPATIAL_CFG.split(","))
    pos, vel, mass = granular_cloud(n_big, seed=0, box=BOX)
    inputs = collide_inputs(pos, vel, mass, 1.0, dev)
    n_cols, k = g * g, g * g // n_slabs
    whole = collide.binned_collision_pass(*inputs, BOX, g, band_cells=b, packed_caps=(tc, sc_))
    got, want, calls1 = slab_both(inputs, BOX, g, b, (tc, sc_), 0, n_cols)
    e, rel = check_rows(f"cloud n={n_big} 1 slab ({tc}, {sc_})", got, want)
    err = max(err, e)
    check(union_is_whole(got[0], got[1], whole) and int(got[2]) == int(whole[5]),
          "1 slab: bitwise the whole-grid pass, n_overflow equal")
    log(21, f"cloud n={n_big} {SPATIAL_CFG}, 1 slab (D = 1): kernel vs plain worst rel {rel:.3e}, bitwise the "
            f"whole-grid pass; n_overflow {int(got[2])}")
    parts, calls4 = [], []
    for s_ in range(n_slabs):
        got, want, calls = slab_both(inputs, BOX, g, b, (tc, sc_), s_ * k, k)
        e, rel = check_rows(f"cloud n={n_big} slab {s_} of {n_slabs}", got, want)
        err = max(err, e)
        parts.append(got)
        calls4 += calls
        log(21, f"cloud n={n_big} slab {s_} of {n_slabs}: kernel vs plain worst rel {rel:.3e}, n_overflow "
                f"{int(got[2])}")
    _, _, ovf = slab_union(parts)
    check(ovf == int(whole[5]), f"{n_slabs} slabs' n_overflow {ovf} sums to the whole grid's {int(whole[5])}")
    caps = collide.packed_caps_for(pos, BOX, g, b)  # zero overflow
    whole_c = collide.binned_collision_pass(*inputs, BOX, g, band_cells=b, packed_caps=caps)
    u_d, u_j, ovf_c = slab_union([collide.packed_collision_blocks_slab(*inputs, BOX, g, b, caps, 0.2, 0.5, s_ * k, k)
                                  for s_ in range(n_slabs)])
    check(ovf_c == 0 and union_is_whole(u_d, u_j, whole_c), f"{n_slabs} slabs at {caps}: bitwise the whole grid's")
    log(21, f"cloud n={n_big}: {n_slabs} slabs' n_overflow at ({tc}, {sc_}) {ovf} = the whole grid's; at "
            f"packed_caps_for {caps} their reduced rows bitwise the whole-grid pass ({int((u_j >= 0).sum())} "
            f"partners, {int(whole_c[4])} bounces)")

    t1 = time_launches(21, f"cloud n={n_big} 1 slab (D = 1) {SPATIAL_CFG}", collide.collide_fused_slab, calls1)
    t4 = time_launches(21, f"cloud n={n_big} {n_slabs} slabs {SPATIAL_CFG}", collide.collide_fused_slab, calls4)
    _, _, fused, calls_w = layout_both(inputs, BOX, g, dict(band_cells=b, packed_caps=(tc, sc_)))
    tw = time_launches(21, f"cloud n={n_big} whole-grid pass {SPATIAL_CFG} (K2)", fused, calls_w)
    log(21, f"1 slab / whole-grid launch {t1['ms'] / tw['ms']:.3f}; {n_slabs} slabs / whole grid "
            f"{t4['ms'] / tw['ms']:.3f}")
    return dict(max_abs_err=err, ms=t1["ms"], plain_ms=t1["plain_ms"], bound_ms=t1["bound_ms"],
                bound_by=t1["bound_by"], library_ms=None)


def momentum(mass: torch.Tensor, vel: torch.Tensor) -> torch.Tensor:
    return (mass.double()[:, None] * vel.double()).sum(0)


def phase_sharded_gravity(dev, n: int = MERGER_N, n_ring: int = HEADLINE_N, ring_steps: int = 2) -> float:
    """The all-gather gravity step at world size 1 on BASELINE config 5's
    1,048,576-body galaxy merger (examples/merger_demo.py's scene, G, eps,
    h): 1 warm-up and 3 timed steps (ms/step, pairs/s), momentum conserved,
    one step under set_sync_debug_mode("error"); run_sharded with
    diag_every (K3's energies, equal to the single-device energy at D = 1);
    the ring and the 2-D step at N = n_ring against the 1-D step; K1 against
    its plain version on the first 4,096 targets. Returns ms/step."""
    mesh = shard.make_mesh(device_type=dev.type)
    sc = scene.galaxy_merger(n, **sharded.MERGER)
    G, eps, h = sharded.G, sharded.EPS, sharded.H
    before = pairwise_acc.launches
    rec, st = sharded.time_gravity(mesh, dev, sc)
    check(pairwise_acc.launches - before == 4, "K1 launched once a step")
    mass0, vel0 = (torch.tensor(sc[f], device=dev) for f in ("mass", "vel"))
    p0 = momentum(mass0, vel0)
    drift = float((momentum(st.mass, st.vel) - p0).norm()) / float((st.mass.double() * st.vel.double().norm(dim=1)).sum())
    check(all_finite(st.pos, st.vel, st.acc), "state finite")
    check(drift < 1e-5, f"momentum conserved ({drift:.3e})")
    log(22, f"make_sharded_step N={n} D={rec['d']}: {rec['ms_per_step']:.3f} ms/step over {rec['steps']} steps "
            f"({rec['pairs_per_s']:.4e} pairs/s); |dP| / sum m|v| = {drift:.3e} (tol 1e-5)")
    step = shard.make_sharded_step(mesh)
    torch.cuda.synchronize()
    torch.cuda.set_sync_debug_mode("error")
    try:
        st = step(st, G, eps, h)
    finally:
        torch.cuda.set_sync_debug_mode("default")
    torch.cuda.synchronize()
    log(22, "one make_sharded_step ran under set_sync_debug_mode('error'): no host sync")

    tgt = st.pos[:4096]
    compare(f"K1 at N={n}, first 4096 targets", pairwise_acc(st.pos, st.mass, G, eps, target_pos=tgt),
            pairwise_acc_reference(st.pos, st.mass, G, eps, tgt, block=256), phase=22)

    st0 = shard.shard_state(mesh, sc["pos"], sc["vel"], sc["mass"])
    ke0, pe0 = shard.sharded_energy(mesh, st0, G, eps)
    st2, none = shard.run_sharded(st0, step, G, eps, h, n_steps=2)
    st3, energies = shard.run_sharded(st0, step, G, eps, h, n_steps=3, diag_every=2, mesh=mesh)
    check(none is None and tuple(energies.shape) == (1, 2) and all_finite(energies, st3.pos),
          "one (KE, PE) sample, finite")
    check(not torch.equal(st3.pos, st2.pos), "the remainder step ran after the sample")
    # the sample against the single-device energy of the state after 2 steps
    ke2 = 0.5 * (st2.mass * (st2.vel * st2.vel).sum(-1)).sum()
    pe2 = potential_energy(st2.pos, st2.mass, G, eps)
    for name, got, want in (("KE", energies[0, 0], ke2), ("PE", energies[0, 1], pe2)):
        rel = abs(float(got) - float(want)) / abs(float(want))
        check(rel < 1e-6, f"run_sharded's {name} sample equals the single-device K3 sum ({rel:.3e})")
    e0, e2 = float(ke0 + pe0), float(energies[0].sum())
    log(22, f"run_sharded 3 steps, diag_every 2: the sample (KE {float(energies[0, 0]):.6e}, PE "
            f"{float(energies[0, 1]):.6e}) equals the single-device sums after 2 steps; E0 {e0:.6e}, "
            f"|E2 - E0| / |E0| = {abs(e2 - e0) / abs(e0):.3e}; the remainder step after it")

    sc2 = scene.galaxy_merger(n_ring, **sharded.MERGER)
    mesh2 = shard.make_mesh(axes=("b", "j"), device_type=dev.type)
    out = {}
    for path, m, place, make in (("1-D", mesh, shard.shard_state, shard.make_sharded_step),
                                 ("ring", mesh, shard.shard_state, shard.make_sharded_step_ring),
                                 ("2-D", mesh2, shard.shard_state2d, shard.make_sharded_step_2d)):
        s2 = place(m, sc2["pos"], sc2["vel"], sc2["mass"])
        stp = make(m)
        s2 = stp(s2, G, eps, h)  # warm-up step, then ring_steps timed
        t0 = torch.cuda.Event(enable_timing=True)
        t1 = torch.cuda.Event(enable_timing=True)
        t0.record()
        for _ in range(ring_steps):
            s2 = stp(s2, G, eps, h)
        t1.record()
        t1.synchronize()
        out[path] = s2
        log(22, f"{path} step N={n_ring} D=1: {t0.elapsed_time(t1) / ring_steps:.3f} ms/step")
    for path in ("ring", "2-D"):
        same = torch.equal(out[path].pos, out["1-D"].pos) and torch.equal(out[path].vel, out["1-D"].vel)
        rel = max(float((getattr(out[path], f) - getattr(out["1-D"], f)).abs().max())
                  / float(getattr(out["1-D"], f).abs().max()) for f in ("pos", "vel"))
        log(22, f"{path} against the 1-D step after {ring_steps + 1} steps at D = 1: bitwise {same} "
                f"(expected: the same K1 launch on the same rows); max rel {rel:.3e}")
        check(rel < 1e-6, f"{path} equals the 1-D step at D = 1")
    return rec["ms_per_step"]


def padded_scene(n: int, n_disk: int):
    """The full-physics scene of phase 4 (reference_galaxy with n_disk disk
    bodies), padded with mass-0 bodies to n: (pos, vel, mass, mat, temp)."""
    sc = scene.reference_galaxy(n_disk=n_disk, seed=0)
    k = len(sc["mass"])
    out = []
    for f in ("pos", "vel", "mass", "mat", "temp"):
        x = np.zeros((n, *sc[f].shape[1:]), sc[f].dtype)
        x[:k] = sc[f]
        out.append(x)
    return out


PHYSICS_COUNTERS = ("n_merges", "n_bounces", "n_fractures", "n_dropped")


def phase_sharded_physics(dev, n: int = 4096, n_disk: int = 3000, steps: int = 20, n_cpu: int = 512,
                          cpu_steps: int = 3) -> float:
    """The dense full-physics step (make_sharded_physics_step) at world size
    1 on phase 4's scene padded to 4,096: 2 warm-up and `steps` timed steps,
    the counters summed, mass conserved where nothing was dropped; then
    cpu_steps steps at N = n_cpu on the card and on the CPU with the same
    fracture uniforms: counters, partners and materials exactly, floats to
    SCALED_CPU_TOL. Returns ms/step."""
    cfg = SimConfig()
    h = sim.substep_size(cfg)
    mesh = shard.make_mesh(device_type=dev.type)
    pos, vel, mass, mat, temp = padded_scene(n, n_disk)
    st = shard.shard_body_state(mesh, pos, vel, mass, mat, temp)
    step = shard.make_sharded_physics_step(mesh, cfg)
    m0 = float(st.mass.double().sum())
    for _ in range(2):
        st, _ = step(st, h)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    cs = []
    for _ in range(steps):
        st, c = step(st, h)
        cs.append(c)
    torch.cuda.synchronize()
    ms = (time.perf_counter() - t0) / steps * 1e3
    tot = {k: int(torch.stack([c[k] for c in cs]).sum()) for k in PHYSICS_COUNTERS}
    check(all_finite(st.pos, st.vel, st.acc, st.mass, st.temp, st.contact_t), "state finite")
    m1 = float(st.mass.double().sum())
    if tot["n_dropped"] == 0:
        check(abs(m1 - m0) <= 1e-5 * m0, f"mass conserved ({m0} -> {m1})")
    log(23, f"make_sharded_physics_step N={n} ({n_disk + 1} live) D=1: {ms:.3f} ms/step over {steps} steps; "
            f"counters summed {tot}; mass {m0:.4f} -> {m1:.4f}; alive {int((st.mass > 0).sum())}")

    cuda_mesh, cpu_mesh = mesh, shard.make_mesh(device_type="cpu")
    pos, vel, mass, mat, temp = padded_scene(n_cpu, n_cpu - 12)
    a = shard.shard_body_state(cuda_mesh, pos, vel, mass, mat, temp)
    b = shard.shard_body_state(cpu_mesh, pos, vel, mass, mat, temp)
    step_a, step_b = step, shard.make_sharded_physics_step(cpu_mesh, cfg)
    gen = torch.Generator().manual_seed(13)
    for i in range(cpu_steps):
        d = draw_fracture_uniforms(cfg, gen, "cpu")
        a, ca = step_a(a, h, d.to(dev))
        b, cb = step_b(b, h, d)
        for k in PHYSICS_COUNTERS:
            check(int(ca[k]) == int(cb[k]), f"step {i}: {k} equal on card and CPU ({int(ca[k])} vs {int(cb[k])})")
    for f in ("partner", "mat"):
        check(torch.equal(getattr(a, f).cpu(), getattr(b, f)), f"{f} equal on card and CPU")
    for f in ("pos", "vel", "acc", "mass", "temp", "contact_t"):
        x, y = getattr(a, f).cpu(), getattr(b, f)
        err = float((x - y).abs().max()) / max(float(y.abs().max()), 1e-30)
        check(err < SCALED_CPU_TOL, f"{f} card vs CPU after {cpu_steps} steps ({err:.3e})")
    log(23, f"N={n_cpu}, {cpu_steps} steps: counters, partners and materials equal on card and CPU, floats within "
            f"{SCALED_CPU_TOL:g}; last counters {{{', '.join(f'{k}: {int(v)}' for k, v in cb.items())}}}")
    return ms


GRANULAR_COUNTERS = ("n_merges", "n_fractures", "n_bounces", "n_overflow", "n_dropped")


def granular_against_scan(dev, mesh, force: str, steps: int = 20, n: int = SCALED_N) -> None:
    """The sharded granular step at D = 1 against the single-device sequence
    (granular_full_kdk_scan with the same packed layout, force and fracture
    uniforms; tests/test_shard.py's chain) on bench spatial's scene, under
    torch.use_deterministic_algorithms (the PM deposit's atomics otherwise
    change its last bits from run to run): every step's counters, and the
    partners, materials and contact timers at the end, exactly; the floats
    bitwise or within 1e-5 of each field's largest magnitude (logged)."""
    g, b, caps, pm_grid = (sharded.GRANULAR[k] for k in ("n_cells", "band_cells", "packed_caps", "pm_grid"))
    pos, vel, mass = granular_cloud(n)
    cfg = granular.bench_config().to(dev)
    gen = torch.Generator().manual_seed(17)
    draws = [draw_fracture_uniforms(cfg, gen, "cpu").to(dev) for _ in range(steps)]
    torch.use_deterministic_algorithms(True, warn_only=True)
    try:
        green = isolated_green_hat(BOX, pm_grid, device=dev) if force == "pm" else None
        st0 = collisions_scaled.make_granular_state(pos, vel, mass, seed=0, device=dev)
        scan_force = "pairwise" if force == "auto" else force
        ref, _, evs = collisions_scaled.granular_full_kdk_scan(
            st0, cfg, BOX, steps, n_cells=g, band_cells=b, packed_caps=caps, force_impl=scan_force, pm_grid=pm_grid,
            log_events=True, green_hat=green, draws=draws)
        st = shard.shard_body_state(mesh, pos, vel, mass)
        if force == "pm":
            st = st._replace(acc=pm_acceleration(st.pos, st.mass, cfg.G, BOX, g=pm_grid, isolated=True,
                                                 green_hat=green))
        elif force == "auto":
            st = st._replace(acc=pairwise_acc(st.pos, st.mass, cfg.G, cfg.softening))
        step = shard.make_sharded_granular_step(mesh, cfg, BOX, g, b, caps, force_impl=force, pm_grid=pm_grid)
        for i in range(steps):
            st, c = step(st, cfg.dt, draws[i])
            for k in GRANULAR_COUNTERS:
                check(int(c[k]) == int(getattr(evs, k)[i]), f"{force} step {i}: {k} {int(c[k])} equals the scan's "
                                                           f"{int(getattr(evs, k)[i])}")
            check(bool(c["cell_too_small"]) == bool(evs.cell_too_small[i]), f"{force} step {i}: cell_too_small")
    finally:
        torch.use_deterministic_algorithms(False)
    for f in ("partner", "mat", "contact_t"):
        check(torch.equal(getattr(st, f), getattr(ref, f)), f"{force}: {f} equal to the scan's")
    bitwise, worst = True, 0.0
    for f in ("pos", "vel", "mass", "temp"):
        x, y = getattr(st, f), getattr(ref, f)
        bitwise = bitwise and torch.equal(x, y)
        worst = max(worst, float((x - y).abs().max()) / max(float(y.abs().max()), 1e-30))
    check(worst < 1e-5, f"{force}: floats within 1e-5 of the scan's ({worst:.3e})")
    tot = {k: int(getattr(evs, k).sum()) for k in GRANULAR_COUNTERS}
    log(24, f"{force} D=1 against the single-device scan, {steps} steps: every counter and partner equal "
            f"(totals {tot}); floats bitwise {bitwise}, max rel {worst:.3e}")


def phase_sharded_granular(dev, spatial_rows, steps: int = 20, n: int = SCALED_N, n_cpu: int = 4096,
                           cpu_steps: int = 3) -> int:
    """The sharded granular step at world size 1 on bench spatial's scene
    (131,072-body cloud, 32,8,96,104, PM 128^3): pm (the slab kernel's path:
    its launches counted from 0 there), auto (K1) and zero, 2 warm-up and
    `steps` timed steps each, beside the spatial step's and the scan's
    ms/step on the same scene (phase 20, `spatial_rows`); each force held
    against the single-device scan (granular_against_scan); one pm step
    under set_sync_debug_mode("error"); cpu_steps steps at N = n_cpu on the
    card and on the CPU with pm and auto. Returns the slab kernel's launches
    on the pm path."""
    mesh = shard.make_mesh(device_type=dev.type)
    launches = 0
    for force in ("pm", "auto", "zero"):
        if force == "pm":
            collide.collide_fused_slab.launches = 0  # the slab kernel's path: the granular step with pm
        rec = sharded.time_granular(mesh, dev, n, force, steps=steps, warmup=2)
        if force == "pm":
            launches = collide.collide_fused_slab.launches
            check(launches == steps + 2, f"pm: the slab kernel launched {launches} times in {steps + 2} steps")
        log(24, f"make_sharded_granular_step N={n} {force} D={rec['d']}: {rec['ms_per_step']:.3f} ms/step over "
                f"{steps} steps; last step's counters {rec['counters']}")
    ref, rec = spatial_rows
    log(24, f"beside it, on the same scene with pm (phase 20): the single-device scan {ref['ms_per_step']:.4f} "
            f"ms/step, the spatial halo-exchange step {rec['ms_per_step']:.4f} ms/step")
    for force in ("pm", "auto", "zero"):
        granular_against_scan(dev, mesh, force, steps=steps, n=n)

    g, b, caps, pm_grid = (sharded.GRANULAR[k] for k in ("n_cells", "band_cells", "packed_caps", "pm_grid"))
    cfg = granular.bench_config()
    step = shard.make_sharded_granular_step(mesh, cfg, BOX, g, b, caps, force_impl="pm", pm_grid=pm_grid)
    st = shard.shard_body_state(mesh, *granular_cloud(n))
    st, _ = step(st, cfg.dt)
    torch.cuda.synchronize()
    before = collide.collide_fused_slab.launches
    torch.cuda.set_sync_debug_mode("error")
    try:
        st, c = step(st, cfg.dt)
    finally:
        torch.cuda.set_sync_debug_mode("default")
    torch.cuda.synchronize()
    check(collide.collide_fused_slab.launches - before == 1, "the slab kernel ran in the sync-checked step")
    log(24, "one pm granular step ran under set_sync_debug_mode('error'): no host sync")
    collide.collide_fused_slab.launches = launches

    # the card against the CPU, one process: a CUDA mesh and a CPU mesh
    cpu_mesh = shard.make_mesh(device_type="cpu")
    box = BOX * (n_cpu / SCALED_N) ** (1.0 / 3.0)
    pos, vel, mass = granular_cloud(n_cpu, seed=0, box=box)
    cfg = granular.bench_config()
    for force in ("pm", "auto"):
        steps_ab = [shard.make_sharded_granular_step(m, cfg, box, 16, 4, (96, 104), force_impl=force, pm_grid=64)
                    for m in (mesh, cpu_mesh)]
        a, b_ = (shard.shard_body_state(m, pos, vel, mass) for m in (mesh, cpu_mesh))
        gen = torch.Generator().manual_seed(11)
        for i in range(cpu_steps):
            d = draw_fracture_uniforms(cfg, gen, "cpu")
            a, ca = steps_ab[0](a, cfg.dt, d.to(dev))
            b_, cb = steps_ab[1](b_, cfg.dt, d)
            for k in ca:
                check(int(ca[k]) == int(cb[k]), f"{force} step {i}: {k} equal on card and CPU ({int(ca[k])} vs "
                                                f"{int(cb[k])})")
        for f in ("partner", "mat"):
            check(torch.equal(getattr(a, f).cpu(), getattr(b_, f)), f"{force}: {f} equal on card and CPU")
        worst = 0.0
        for f in ("pos", "vel", "acc", "mass", "temp", "contact_t"):
            x, y = getattr(a, f).cpu(), getattr(b_, f)
            err = float((x - y).abs().max()) / max(float(y.abs().max()), 1e-30)
            check(err < SCALED_CPU_TOL, f"{force}: {f} card vs CPU after {cpu_steps} steps ({err:.3e})")
            worst = max(worst, err)
        log(24, f"N={n_cpu} {force}, {cpu_steps} granular steps: counters, partners and materials equal on card "
                f"and CPU, floats max rel {worst:.3e} (tol {SCALED_CPU_TOL:g}); last counters "
                f"{{{', '.join(f'{k}: {int(v)}' for k, v in cb.items())}}}")
    return launches


# ---- the precision variants of K1: K1a "f32", K1b "fast", K1c "mxu", K1d "hyb", K1e "bf16" ----

def variant_wrapper(precision: str):
    return getattr(pairwise, f"pairwise_acc_{precision}")


def float64_acc(pos, mass, G: float, eps: float) -> torch.Tensor:
    """The direct sum in float64 on the card, the ladder's reference."""
    p, m = pos.double(), mass.double()
    d = p[None] - p[:, None]
    r2 = (d * d).sum(-1) + f32(eps) ** 2
    return G * ((m[None] * r2**-1.5)[..., None] * d).sum(1)


def variant_checks(dev, precision: str, n_big: int = HEADLINE_N) -> float:
    """One variant's kernel against its plain version on the card (random,
    rectangular, ragged, one source tile, mass-0 sources, mass-0 padding
    inert, the cold-collapse disk's first 4,096 targets), one launch a call,
    and its ladder bar against float64; "f32" and "hyb" bitwise, each
    kernel twice on the same inputs bitwise. Returns the largest
    max|kernel - plain|."""
    G, eps, tol = 0.5, 0.5, VARIANT_TOL[precision]
    wrapper = variant_wrapper(precision)

    def both(label, pos, mass, tgt=None, self_pairs=True, eps=eps):
        before = wrapper.launches
        got = pairwise_acc(pos, mass, G, eps, tgt, precision)
        check(wrapper.launches == before + 1, f"{precision}: one launch a call")
        want = pairwise_acc_reference(pos, mass, G, eps, tgt, precision=precision)
        nt = pos.shape[0] if tgt is None else tgt.shape[0]
        label += f"; {split_text(precision, nt, pos.shape[0])}"
        check(torch.equal(got, pairwise_acc(pos, mass, G, eps, tgt, precision)), f"{precision}: two launches bitwise")
        if precision in BITWISE:
            check(torch.equal(got, want), f"{precision} {label}: bitwise its plain version")
        return compare(f"{precision} {label}", got, want, 25, variant_tol(precision, self_pairs))

    pos, mass = rand_bodies(4096, 0, dev)
    err = both("N=4096 random", pos, mass)
    err = max(err, both("1000 targets x 4096 sources", pos, mass, pos[37:1037]))
    sep, _ = rand_bodies(1000, 3, dev)
    err = max(err, both("1000 separate targets x 4096 sources", pos, mass, sep, self_pairs=False))
    src, m_src = rand_bodies(3001, 1, dev)
    tgt, _ = rand_bodies(777, 2, dev)
    err = max(err, both("777 targets x 3001 sources (ragged)", src, m_src, tgt, self_pairs=False))
    err = max(err, both("777 targets x 255 sources (one tile: S = 1)", src[:255], m_src[:255], tgt, self_pairs=False))
    src, m_src = rand_bodies(SHORT_LAST_SPLIT_N, 4, dev)
    err = max(err, both(f"N={SHORT_LAST_SPLIT_N} random (a shorter last split)", src, m_src))
    # eps^2 = 1e-40, below FLT_MIN: the rsqrtf instantiation, on targets 300
    # away in each coordinate (nothing near goes unsoftened)
    err = max(err, both("1000 targets outside 4096 sources, softening 1e-20", pos, mass, sep + 300.0,
                        self_pairs=False, eps=1e-20))
    m_pad = mass.clone()
    m_pad[2048:] = 0.0
    err = max(err, both("half the sources mass 0", pos, m_pad))
    # mass-0 sources where nbx and the plain version pad (the origin) add
    # nothing; elsewhere they move "fast"'s and "hyb"'s tile centroids and so
    # their roundings, as on the TPU
    p_pad = pos.clone()
    p_pad[2048:] = 0.0
    got = pairwise_acc(p_pad, m_pad, G, eps, pos[:2048], precision)
    err = max(err, compare(f"{precision} mass-0 padding inert", got,
                           pairwise_acc_reference(pos[:2048], mass[:2048], G, eps, precision=precision), 25, tol))
    cfg = SimConfig()
    sc = scene.cold_collapse_disk(n=n_big, seed=0)
    pos, mass = torch.tensor(sc["pos"], device=dev), torch.tensor(sc["mass"], device=dev)
    got = pairwise_acc(pos, mass, cfg.G, cfg.softening, precision=precision)[:4096]
    check(all_finite(got), f"{precision} output finite at N={n_big}")
    # the plain version on the first 4,096 targets, its tiles added in the
    # runs of the kernel's grid over all n_big
    splits = pairwise.source_splits(n_big, n_big, pairwise.SPLIT_KERNELS[precision][0])
    want = pairwise_acc_reference(pos, mass, cfg.G, cfg.softening, pos[:4096], precision=precision, splits=splits)
    check(precision not in BITWISE or torch.equal(got, want), f"{precision} on the disk: bitwise its plain version")
    err = max(err, compare(f"{precision} N={n_big} cold_collapse_disk, first 4096 targets", got, want, 25, tol))
    pos, mass = rand_bodies(2048, 1, dev)
    want = float64_acc(pos, mass, G, eps)

    def ladder_of(acc):
        return float((acc.double() - want).abs().max() / want.abs().max())
    got = pairwise_acc(pos, mass, G, eps, precision=precision)
    ladder = ladder_of(got)
    log(25, f"{precision} ladder: max|kernel - float64| / max|float64| = {ladder:.3e} on _rand(2048, 1) "
            f"(bar {LADDER[precision]:g}{', and > 0' if precision == 'bf16' else ''})")
    check(ladder < LADDER[precision] and (precision != "bf16" or ladder > 0), f"{precision} on its ladder bar")
    if precision in TENSOR_CORE_VARIANTS:  # their sums leave the kernel on its plain version's ladder
        plain = pairwise_acc_reference(pos, mass, G, eps, precision=precision)
        ratios = ladder_ratios(got, plain, want)
        log(25, f"{precision} ladder: plain version {ladder_of(plain):.3e} (max ratio "
                f"{ladder / ladder_of(plain):.3f}, not gated); the bodies' errors, kernel over plain, at quantiles "
                + ", ".join(f"{q:g}: {r:.4f}" for q, r in zip(LADDER_QUANTILES, ratios))
                + f" (bars {1 / LADDER_VS_PLAIN:.4f} to {LADDER_VS_PLAIN:g})")
        check(within_ladder(ratios), f"{precision}'s ladder within its plain version's")
    return err


def near_pairs(dev, nt: int = 25_600, ns: int = 1_792) -> None:
    """fast and mxu on nt random targets apart from ns random sources:
    max|kernel - plain| / max|plain| over all targets and over those whose
    nearest source lies beyond 1 and 2 eps. A measurement, not gated: a
    target within eps of a source cancels that pair's term as a self pair
    does, so the separate-target bar does not hold there."""
    src, m = rand_bodies(ns, 4, dev)
    tgt, _ = rand_bodies(nt, 5, dev)
    near = torch.cdist(tgt.double(), src.double()).min(1).values
    for p in TENSOR_CORE_VARIANTS:
        got = pairwise_acc(src, m, 0.5, 0.5, tgt, p)
        want = pairwise_acc_reference(src, m, 0.5, 0.5, tgt, precision=p)
        err = (got - want).abs().amax(1) / want.abs().max()
        log(25, f"{p} {nt} targets apart from {ns} sources: rel {float(err.max()):.3e} over all, "
                + ", ".join(f"{float(err[near > 0.5 * k].max()):.3e} beyond {k} eps ({int((near <= 0.5 * k).sum())} "
                            "within)" for k in (1, 2)))


def variant_bound(p: str, n: int) -> dict:
    """Variant p's bound for N = n targets and sources."""
    nbytes = n * (12 + 16 + 12) + (16 * n if p in ("f32", "fast") else 0)
    return bound(n * n * VARIANT_PAIR_OPS[p], n * n, nbytes, n * n * VARIANT_PAIR_CVT[p],
                 n * n * VARIANT_PAIR_TC_FLOPS.get(p, 0.0), n * n * VARIANT_PAIR_BF16.get(p, 0))


def turns_with_k1(args, reps: int, precisions, n: int) -> tuple[dict, list]:
    """Each precision's kernel at N = n timed in turns with K1 (K1 first and
    last; each warmed up first). Returns ({precision: ms}, [K1 before,
    after])."""
    def run(p):
        return lambda: pairwise_acc(*args, precision=p)
    k1 = [cuda_ms(lambda: pairwise_acc(*args), reps)]
    out = {}
    for p in precisions:
        run(p)()  # warm-up
        out[p] = cuda_ms(run(p), reps)
    k1.append(cuda_ms(lambda: pairwise_acc(*args), reps))
    log(25, f"N={n}: K1 (f32r) in the same process {k1[0]:.4f} ms before the variants, {k1[1]:.4f} after; "
            "variant/K1: " + ", ".join(f"{p} {out[p] / k1[0]:.3f}x" for p in precisions))
    return out, k1


def variant_timings(dev, n: int = HEADLINE_N, n_small: int = DRIFT_N) -> dict:
    """Each variant's kernel at N = n on the cold-collapse disk and at the
    drift gate's N = n_small (the shape of the path whose launches the
    kernels line counts), timed in turns with K1, with its bound; its plain
    version once at n. The split kernels' grids at both."""
    cfg = SimConfig()
    sc = scene.cold_collapse_disk(n=n, seed=0)
    pos, mass = torch.tensor(sc["pos"], device=dev), torch.tensor(sc["mass"], device=dev)
    args = (pos, mass, cfg.G, cfg.softening)
    small = drift.gate_scene(n_small, device=dev)
    small_args = (small[0], small[2], small[3], small[4])
    for size in (n_small, n):
        for p in pairwise.SPLIT_KERNELS:
            log(25, f"{p} N={size}: {split_text(p, size, size)}")
    big, _ = turns_with_k1(args, 3, VARIANTS, n)
    small_ms, _ = turns_with_k1(small_args, 20, VARIANTS, n_small)
    out = {}
    for p in VARIANTS:
        plain_ms = cuda_ms(lambda: pairwise_acc_reference(*args, precision=p), 1)
        b, b_small = variant_bound(p, n), variant_bound(p, n_small)
        ms = big[p]
        out[p] = dict(ms=ms, plain_ms=plain_ms, **record(b), library_ms=None, ms_drift_shape=small_ms[p],
                      bound_ms_drift_shape=b_small["bound_ms"])
        log(25, f"{p} N={n}: kernel {ms:.3f} ms ({n * n / (ms * 1e-3):.4e} pairs/s), plain {plain_ms:.3f} ms, "
                f"plain/kernel {plain_ms / ms:.2f}x; {bound_text(b)}; kernel/bound {ms / b['bound_ms']:.2f}")
        log(25, f"{p} N={n_small} (the drift gate's sphere): kernel {small_ms[p]:.4f} ms; {bound_text(b_small)}; "
                f"kernel/bound {small_ms[p] / b_small['bound_ms']:.2f}")
    return out


def sass_name(fn: str) -> str:
    """A kernel function's demangled name without its parameter list,
    template arguments kept."""
    return fn[: fn.index(">(") + 1] if ">(" in fn else fn.split("(")[0]


def variant_sass() -> None:
    """`bench.sass` on K1 and the variants' kernels: instructions a pair in
    their inner loops; K1b's and K1c's products on the tensor cores (HMMA),
    K1b's FFMAs below the 12 a pair of the CUDA-core products it replaced;
    K1e's products packed (HMUL2), at most 2 F2FP a pair."""
    buf = io.StringIO()
    with contextlib.redirect_stdout(buf):
        rows = sass.main(("pairwise_f32r", "pairwise_fast", "pairwise_precision", "pairwise_mxu"))
    for r in rows:
        log(25, f"sass {sass_name(r['function'])}: {r['pairs_in_loop']} pairs in the loop, "
                f"{r['instructions_a_pair']:.4f} instructions a pair: "
                + ", ".join(f"{op} {n:.4g}" for op, n in r["by_opcode"].items()))

    def loops(name):
        return [r["by_opcode"] for r in rows if name in r["function"]]
    check(len(loops("pairwise_fast_kernel")) == 2 and all(
        any(op.startswith("HMMA") for op in ops) and ops.get("FFMA", 0) < 12 for ops in loops("pairwise_fast_kernel")),
          "K1b's inner loop runs HMMA, with fewer than 12 FFMAs a pair")
    check(len(loops("pairwise_mxu_kernel")) == 2 and all(
        any(op.startswith("HMMA") for op in ops) for ops in loops("pairwise_mxu_kernel")), "K1c's inner loop runs HMMA")
    check(len(loops("pairwise_bf16_kernel")) == 2 and all(
        any(op.startswith("HMUL2") for op in ops) and sum(n for op, n in ops.items() if op.startswith("F2FP")) <= 2
        for ops in loops("pairwise_bf16_kernel")), "K1e's inner loop runs HMUL2, at most 2 F2FP a pair")


def pair_sass() -> None:
    """`bench.sass` on K5 (pp_react), K6 (pairwise_accjerk), K4 (pp_short)
    and K3 (potential): instructions a pair in their inner loops. Each of
    K5's and K4's pair kernels evaluates the law once a pair: one MUFU.RSQ,
    one MUFU.EX2 and one MUFU.RCP a pair in its loop; K3's one MUFU.RSQ and
    no other special function."""
    buf = io.StringIO()
    with contextlib.redirect_stdout(buf):
        rows = sass.main(("pp_react", "pairwise_accjerk", "pp_short", "potential"))
    for r in rows:
        log(25, f"sass {r['source']} {sass_name(r['function'])}: {r['pairs_in_loop']} pairs in the loop, "
                f"{r['instructions_a_pair']:.4f} instructions a pair: "
                + ", ".join(f"{op} {n:.4g}" for op, n in r["by_opcode"].items()))
    react = [r["by_opcode"] for r in rows if "pp_react_kernel" in r["function"]]
    check(len(react) == 2 and all(
        all(ops.get(f"MUFU.{f}", 0) == 1 for f in ("RSQ", "EX2", "RCP")) for ops in react),
          "K5's pair loops run one MUFU.RSQ, one MUFU.EX2 and one MUFU.RCP a pair")
    short = [r["by_opcode"] for r in rows if "pp_short_kernel" in r["function"]]
    check(len(short) == 2 and all(
        all(ops.get(f"MUFU.{f}", 0) == 1 for f in ("RSQ", "EX2", "RCP")) for ops in short),
          "K4's pair loops run one MUFU.RSQ, one MUFU.EX2 and one MUFU.RCP a pair")
    pot = [r["by_opcode"] for r in rows if "potential_kernel" in r["function"]]
    check(len(pot) == 2 and all(
        ops.get("MUFU.RSQ", 0) == 1 and sum(n for op, n in ops.items() if op.startswith("MUFU")) == 1 for ops in pot),
          "K3's pair loops run one MUFU.RSQ a pair and no other MUFU")
    check(len([r for r in rows if "pairwise_accjerk_kernel" in r["function"] and r["pairs_in_loop"] > 0]) == 2,
          "K6's two instantiations each have a pair loop")


def collide_sass() -> None:
    """`bench.sass` on the collision kernel (K2, K2m, K8, the slab entry and
    the probes at each R; K7 with kGrav): instructions a lane and a pair of
    its overlap loop. K2's loop holds no special function (its rsqrtf is on
    the hit path); K7's evaluates the law on every lane: one MUFU.RSQ,
    MUFU.EX2 and MUFU.RCP a lane a target."""
    buf = io.StringIO()
    with contextlib.redirect_stdout(buf):
        rows = sass.main(("collide_fused",))
    for r in rows:
        log(25, f"sass {r['source']} {sass_name(r['function'])}: {r['lanes_in_loop']} lanes in the loop, "
                f"{r['targets_a_thread']} targets a thread, {r['instructions_a_lane']:.4f} instructions a lane, "
                f"{r['instructions_a_pair']:.4f} a pair: " + ", ".join(f"{op} {n:.4g}" for op, n in r["by_opcode"].items()))
    check(len(rows) >= 2 and all(r["lanes_in_loop"] >= 4 for r in rows), "every collision kernel has an overlap loop")
    for r in rows:
        mufu = {op: n for op, n in r["by_opcode"].items() if op.startswith("MUFU")}
        if re.search(r"\(bool\)1|\btrue\b|Lb1E", r["function"]):
            check(all(mufu.get(f"MUFU.{f}", 0) == r["targets_a_thread"] for f in ("RSQ", "EX2", "RCP")),
                  f"K7's overlap loop evaluates the law once a lane a target: {mufu}")
        else:
            check(not mufu, f"K2's overlap loop holds no special function: {mufu}")


def variant_cvt_rate() -> None:
    """`bench.cvt_rate`: the conversion loop's rates a clock an SM; the
    packed form's is held within CVT_VALUES_TOL of the CVT_VALUES that
    CVT_PEAK holds."""
    buf = io.StringIO()
    with contextlib.redirect_stdout(buf):
        rows = cvt_rate.main()
    for r in rows:
        log(25, f"cvt_rate {r['form']}: {r['instructions_a_clock_an_sm']:.3f} instructions, "
                f"{r['values_a_clock_an_sm']:.3f} values a clock an SM (SMs {r['least']:.3f} to {r['most']:.3f} "
                f"values) over {r['sms']} SMs; {r['ms']:.3f} ms, {r['values_per_s']:.4e} values/s, "
                f"{r['implied_ghz']:.3f} GHz; loop: " + ", ".join(f"{op} {n:g}" for op, n in r["loop_opcodes"].items()))
    check(all(r["values_a_clock_an_sm"] > 0 and any(op.startswith("F2F") for op in r["loop_opcodes"])
              for r in rows), "the conversion loops run F2FP / F2F at a positive rate")
    packed = next(r["values_a_clock_an_sm"] for r in rows if r["form"] == "bf16x2")
    log(25, f"the bounds count conversions at CVT_VALUES = {CVT_VALUES} values a clock an SM; measured "
            f"{packed:.3f}, {packed / CVT_VALUES - 1:+.2%} (tol {CVT_VALUES_TOL:.0%})")
    check(abs(packed / CVT_VALUES - 1) < CVT_VALUES_TOL,
          f"the packed form's {packed:.3f} values a clock an SM within {CVT_VALUES_TOL:.0%} of CVT_VALUES")


def variant_throughput(dev, n: int = HEADLINE_N, reps: int = 10) -> None:
    """`bench throughput` through its main with every precision in one
    process; its JSON lines are read back from its output."""
    buf = io.StringIO()
    with contextlib.redirect_stdout(buf):
        throughput.main(n, reps, ",".join(("f32r",) + VARIANTS), device=dev)
    print(buf.getvalue(), end="", flush=True)
    rows = [json.loads(line) for line in buf.getvalue().splitlines() if line.startswith("{")]
    check([r["precision"] for r in rows] == ["f32r", *VARIANTS], "one throughput line a precision")
    check(all(r["value"] > 0 and r["device"] == timing.device_name(dev) for r in rows), "rates positive, device named")
    log(25, f"bench throughput N={n}: " + ", ".join(f"{r['precision']} {r['ms_per_eval']:.3f} ms" for r in rows))


def variant_drift(dev, precision: str, n: int = DRIFT_N, n_steps: int = 10_000, diag_every: int = 100) -> int:
    """`bench drift` through its main at one precision: BASELINE config 4's
    drift at the gate's fixed step, a measurement (phase 12 keeps the gate).
    Returns the variant's launches on that path: the warm-up's force and the
    run's n_steps + 1; K1 launches none."""
    wrapper = variant_wrapper(precision)
    wrapper.launches = pairwise_acc.launches = 0  # the variant's drift path starts here
    r = drift.main(n, n_steps, precision, diag_every=diag_every, device=dev)
    launches = wrapper.launches
    check(launches == n_steps + 2 and pairwise_acc.launches == 0,
          f"{precision}: {launches} launches of its kernel and {pairwise_acc.launches} of K1 in {n_steps} steps")
    check(r["finite"] and r["n_energies"] == n_steps // diag_every + 1, f"{precision}: 101 finite energies")
    log(25, f"{precision} drift over {r['steps']} steps at N={n}: {r['value']:.4e} (gate {r['gate']:g}, "
            f"pass {r['pass']}, a measurement here); {r['ms_per_step']:.4f} ms/step; {launches} launches")
    pos, vel, mass, G, eps, h = drift.gate_scene(n, device=dev)

    def force(x):
        return pairwise_acc(x, mass, G, eps, precision=precision)
    # a measurement: the launches are counted exactly above (the profiler
    # once saw 99 of the 100 variant launches)
    state = integrators.PhaseState(pos, vel, force(pos))
    per_step, wall_ms, dev_ms, own_ms = launches_per_step(
        state, force, h, diag_every, ("pairwise_", "combine_splits"), 2)
    log(25, f"{precision} under torch.profiler, {diag_every} steps: {per_step:.2f} kernels per step, "
            f"{wall_ms:.4f} wall ms per step, {dev_ms:.4f} device ms per step (busy {dev_ms / wall_ms:.3f}), "
            f"its kernels {own_ms:.4f} of it")
    # the share of the second launch, in a chunk of its own
    *_, combine_ms = launches_per_step(state, force, h, diag_every, ("combine_splits",))
    log(25, f"{precision}: combine_splits {combine_ms:.4f} device ms per step of the pair's {own_ms:.4f}")
    torch.cuda.synchronize()
    torch.cuda.set_sync_debug_mode("error")
    try:
        _, _, e = drift.drift_run(pos, vel, mass, G, eps, h, diag_every, diag_every, precision)
    finally:
        torch.cuda.set_sync_debug_mode("default")
    torch.cuda.synchronize()
    check(all_finite(e), f"{precision}: the sync-checked chunk's energies finite")
    return launches


def variant_steps_vs_cpu(dev, precision: str, n: int = 1024, steps: int = 10) -> None:
    """10 compensated KDK steps at N = 1,024 (the gate's sphere) on the card
    and on the CPU, at one precision."""
    runs = [drift.drift_run(*drift.gate_scene(n, device=d), steps, steps, precision) for d in (dev, "cpu")]
    for name, x, y in zip(("pos", "vel", "energies"), *runs):
        err = float((x.cpu() - y).abs().max()) / max(float(y.abs().max()), 1e-30)
        log(25, f"{precision} N={n}, {steps} steps card vs CPU: {name} max rel err {err:.3e} (tol {SCALED_CPU_TOL:g})")
        check(err < SCALED_CPU_TOL, f"{precision} {name} card vs CPU after {steps} steps")


def phase_precisions(dev, latency_ns=(DRIFT_N, HEADLINE_N)) -> dict:
    """Phase 25: the precision variants K1a, K1b, K1c, K1d, K1e. Each kernel
    against its plain version and its ladder bar; fast's and mxu's errors
    by the nearest source; each timed at 262,144 and 16,384 beside K1; the
    conversion loop (`bench.cvt_rate`); `bench.sass` on K1 and the variants'
    kernels, and on K5, K6 and K4; `bench throughput` with
    every precision; `bench drift` at each (launches on that path, a
    profiled chunk, one sync-checked chunk); `bench latency`'s step at
    16,384 and 262,144; 10 steps at 1,024 card against CPU. Returns each
    variant's entry of the kernels line."""
    errs = {p: variant_checks(dev, p) for p in VARIANTS}
    near_pairs(dev)
    recs = variant_timings(dev)
    variant_cvt_rate()
    variant_sass()
    pair_sass()
    collide_sass()
    variant_throughput(dev)
    for p in VARIANTS:
        recs[p].update(launches=variant_drift(dev, p), max_abs_err=errs[p])
        lat = {n: latency.step_latency_ms(n, 100 if n <= DRIFT_N else 8, precision=p, device=dev)
               for n in latency_ns}
        check(all(0 < ms < float("inf") for ms in lat.values()), f"{p} latencies positive and finite")
        log(25, f"{p} p50 ms per KDK step: " + ", ".join(f"N={n}: {ms:.4f}" for n, ms in lat.items()))
        variant_steps_vs_cpu(dev, p)
    return recs


# ---- the layout probes: K2 re-launched by bench/layoutsplit.py and bench/layoutvar.py ----

PROBE_SITES = {"layoutsplit": "nbx/bench/layoutsplit.py:143", "layoutvar": "nbx/bench/layoutvar.py:199"}


def probe_kernel(dev, n: int = SCALED_N, g: int = 32, band: int = 8) -> tuple[float, dict]:
    """The probes' K2 launch on bucket 0 of the n-body cloud (the probes'
    first default) against its plain version (deltas to KERNEL_TOL, bounce
    counts and partners exact), the "blocks" layout bitwise the "desc"
    layout, each launch timed. Returns (max|kernel - plain|, each probe's
    timing by name)."""
    pos, vel, mass, radius, box, buckets = layoutsplit.scene(n, g, band, dev)
    b = layoutsplit.build(pos, vel, mass, radius, box, g, band, buckets[0])
    got_d, got_j = layoutsplit.launch(b, n)
    want_d, want_j = layoutsplit.launch(b, n, collide.collide_fused_reference)
    err = compare(f"probe bucket 0 n={n} g={g} B={band} bucket {buckets[0]}: deltas", got_d[:, :7], want_d[:, :7],
                  26)
    check(torch.equal(got_d[:, 7], want_d[:, 7]) and torch.equal(got_j, want_j), "bounce counts and partners exact")
    bounces = int(got_d[:, 7].sum())
    check(bounces > 0, "the probe's bucket finds contacts")
    desc = layoutvar.once(pos, vel, mass, radius, box, g, band, buckets[0], "desc")
    blocks = layoutvar.once(pos, vel, mass, radius, box, g, band, buckets[0], "blocks")
    check(all(torch.equal(x, y) for x, y in zip(desc, blocks)), '"blocks" bitwise "desc"')
    log(26, f'probe bucket 0: {bounces} target-side bounces; "blocks" bitwise "desc"')
    out = {}
    for probe, layout in (("layoutsplit", b), ("layoutvar", layoutvar.blocks(b))):
        rec, calls = record_launches(collide.collide_fused)
        layoutsplit.launch(layout, n, rec)
        out[probe] = time_launches(26, f"{probe}'s K2 launch ({'desc' if probe == 'layoutsplit' else 'blocks'} "
                                       f"layout, {layout.feats.shape[0]} rows)", collide.collide_fused, calls)
    return err, out


def probe_main(probe, names, launches_per_n: int) -> int:
    """A probe's main at its defaults, its JSON lines read back from its
    output, each of its stages or variants (names) timed; returns its K2
    launches, which must be launches_per_n per N."""
    collide.collide_fused.launches = 0  # the probe's path starts here
    buf = io.StringIO()
    with contextlib.redirect_stdout(buf):
        rows = probe.main()
    print(buf.getvalue(), end="", flush=True)
    lines = [json.loads(line) for line in buf.getvalue().splitlines() if line.startswith("{")]
    launches = collide.collide_fused.launches
    name = probe.__name__.rsplit(".", 1)[1]
    check(launches == launches_per_n * len(rows), f"{name}: {launches} K2 launches")
    check([r["n"] for r in rows] == [SCALED_N, HEADLINE_N] and len(lines) >= len(rows), f"{name}: a line per N")
    keys = [f"ms_{s}" for s in names]
    check(all(all(0 < r[k] < float("inf") for k in keys) for r in rows), f"{name}: every time positive")
    check(all(not any(k.startswith("mismatch") for k in r) for r in rows), f"{name}: no variant mismatches")
    for r in rows:
        log(26, f"{name} n={r['n']} bucket0={r['bucket0']}: " + ", ".join(f"{k} {r[k]:.4f}" for k in keys))
    return launches


def phase_probes(dev) -> dict:
    """Phase 26: the layout probes. The probes' K2 launch against its plain
    version on the 131,072-body cloud's bucket 0, "blocks" bitwise "desc",
    each timed; each probe's main at its defaults (131,072 at 32,8 and
    262,144 at 40,8), its K2 launches counted. Returns each probe's entry
    of the kernels line."""
    err, recs = probe_kernel(dev)
    steps, warmup = 16, 4  # the mains' chains
    launches = {"layoutsplit": probe_main(layoutsplit, layoutsplit.STAGES, steps + warmup),
                "layoutvar": probe_main(layoutvar, layoutvar.VARIANTS, len(layoutvar.VARIANTS) * (1 + steps + warmup))}
    return {p: dict(recs[p], launches=launches[p], max_abs_err=err, library_ms=None) for p in PROBE_SITES}


# ---- the strict-sequential sweep, the two-level P3M residual, the host API ----

SEQ_TEST_OPS = 11  # FP32 operations of an overlap test (csrc/collide_sequential.cu)
SMS = 132  # the H100 SXM's SMs; the one-block sweep runs on one of them
# bytes a body the sweep must read (pos, vel, temp, mass, radius, inverse
# mass, material, alive) and write (pos, vel, temp, removed)
SEQ_BODY_BYTES = 12 + 12 + 4 + 4 + 4 + 4 + 4 + 1 + 12 + 12 + 4 + 1
SEQ_FLOAT_FIELDS = ("pos", "vel", "temp", "contact", "mbuf", "fbuf")
SEQ_EXACT_FIELDS = ("removed", "counts", "mmat", "fmat")


def chain_pile(n: int = 5, spacing: float = 2.5, mass: float = 20.0) -> dict:
    """The contact pile of tests/test_sequential.py: n bodies on a line at
    `spacing` < 2 r, the outer ones converging."""
    pos = np.zeros((n, 3), np.float32)
    pos[:, 0] = (np.arange(n) - (n - 1) / 2) * spacing
    pos[:, 1] = np.linspace(0.0, 0.3, n)
    vel = np.zeros((n, 3), np.float32)
    vel[:, 0] = -np.sign(pos[:, 0]) * 1.5
    return dict(pos=pos, vel=vel, mass=np.full(n, mass, np.float32), mat=np.zeros(n, np.int32),
                temp=np.zeros(n, np.float32))


def fracture_scene() -> dict:
    """Two violent head-on pairs (fractures), a slow pair (a merge, given a
    running timer) and a gentle pair (a bounce), all overlapping
    (tests/test_torch_sequential.py)."""
    pos = [[-1.5, 0, 0], [1.5, 0, 0.5], [20, 0, 0], [22.5, 0.2, 0], [-20, 0, 0], [-18.2, 0, 0],
           [0, 20, 0], [0, 22, 0.1]]
    vel = [[30, 0, 0], [-30, 0, 0], [10, 0, 0], [-10, 0, 0], [0.1, 0, 0], [-0.1, 0, 0], [0, 1, 0], [0, -1, 0]]
    return dict(pos=np.array(pos, np.float32), vel=np.array(vel, np.float32),
                mass=np.array([100, 100, 20, 20, 5, 5, 5, 5], np.float32),
                mat=np.array([0, 2, 0, 1, 0, 0, 2, 0], np.int32), temp=np.array([0, 50, 0, 0, 0, 0, 0, 0], np.float32))


def lattice_pile(side: int = 16, spacing: float = 2.75, seed: int = 3) -> tuple[dict, np.ndarray]:
    """side^3 bodies of mass 10 (radius 1.34) on a jittered lattice, about a
    quarter of the neighbour pairs overlapping, random velocities; the timers
    of every seventh x-neighbour pair already past merge_time. Returns
    (scene, timers)."""
    rng = np.random.default_rng(seed)
    n = side**3
    grid = np.stack(np.meshgrid(*[np.arange(side)] * 3, indexing="ij"), -1).reshape(n, 3)
    pos = ((grid - (side - 1) / 2) * spacing + rng.normal(0, 0.08, (n, 3))).astype(np.float32)
    sc = dict(pos=pos, vel=rng.normal(0, 1.0, (n, 3)).astype(np.float32), mass=np.full(n, 10.0, np.float32),
              mat=rng.integers(0, 3, n).astype(np.int32), temp=np.zeros(n, np.float32))
    timers = np.zeros((n, n), np.float32)
    i = np.arange(0, n - side * side, 7)
    timers[i, i + side * side] = timers[i + side * side, i] = 0.6
    return sc, timers


def push_line(masses, slots, depth: float = 1.8, gap: float = 2.1, speed: float = 2.0) -> dict:
    """Bodies of `masses` on the x axis in chain order, body k in slot
    slots[k] (rock): the first, moving +x at `speed`, overlaps the second by
    depth r_1; each later body starts gap (r_k-1 + r_k) from the one before,
    beyond the walk's near margin (ops/sequential.py NEAR_SCALE = 2), and at
    rest. Each mass is a thousandth of the one before, so each bounce's
    correction carries the lighter body past its share of the margin into
    the next: the walk's escape path."""
    r = [(3.0 * m / (4.0 * np.pi)) ** (1.0 / 3.0) for m in masses]
    x = [0.0, r[0] + r[1] - depth * r[1]]
    for k in range(2, len(masses)):
        x.append(x[-1] + gap * (r[k - 1] + r[k]))
    n = len(masses)
    pos, vel = np.zeros((n, 3), np.float32), np.zeros((n, 3), np.float32)
    mass = np.zeros(n, np.float32)
    for k, s in enumerate(slots):
        pos[s] = (x[k], 0.01 * k, 0.0)
        mass[s] = masses[k]
    vel[slots[0], 0] = speed
    return dict(pos=pos, vel=vel, mass=mass, mat=np.zeros(n, np.int32), temp=np.zeros(n, np.float32))


def _timers(c: int, pairs) -> np.ndarray:
    t = np.zeros((c, c), np.float32)
    for i, j, v in pairs:
        t[i, j] = t[j, i] = v
    return t


def sequential_scenes() -> dict:
    """The sweep's scenes, name -> (config, scene, timers or None), each in
    contact at its first substep: the four of tests/test_sequential.py (the
    isolated pair bouncing, the 5-body chain pile, the slow merge with its
    timer past merge_time, the 6-body pile merging and bouncing), a head-on
    fracture scene at a low fracture_threshold, two scenes that reach the
    walk's escape path (push_line: a gap chain, each correction pushing the
    next body, which touched no one at the start, into contact, in its own
    row or as an escaped partner; a pushed body hitting, in its own row, a
    body it never neared), the fracture scene at the kernel's largest
    capacity, and a 4,096-body pile."""
    iso = scene.head_on_collision()
    iso["pos"][:, 0], iso["pos"][:, 2] = [-2.5, 2.5], [0, 2]
    slow = scene.head_on_collision()
    slow["pos"][:, 0], slow["pos"][:, 2], slow["vel"][:, 0] = [-2.5, 2.5], [0, 0], [0.2, -0.2]
    pile6 = chain_pile(6, 2.2, 10.0)
    pile6["vel"][:, 0] = -0.5 * pile6["pos"][:, 0]
    lattice, lattice_timers = lattice_pile()
    off = dict(merge_time=1e9, fracture_threshold=1e9)
    return {
        "isolated pair": (SimConfig(capacity=16, **off), iso, None),
        "5-body chain pile": (SimConfig(capacity=8, **off), chain_pile(), None),
        "slow merge": (SimConfig(capacity=16, fracture_threshold=1e9), slow, _timers(16, [(0, 1, 0.6)])),
        "6-body pile with merges": (SimConfig(capacity=16, merge_time=0.1, fracture_threshold=1e9), pile6,
                                    _timers(16, [(2, 3, 0.2), (4, 5, 0.2)])),
        "head-on fracture": (SimConfig(capacity=64, merge_time=0.1, fracture_threshold=5.0), fracture_scene(),
                             _timers(64, [(4, 5, 0.2)])),
        "gap chain": (SimConfig(capacity=16, **off), push_line([1e4, 10.0, 1e-2, 1e-5, 1e-8], [0, 2, 1, 3, 4]), None),
        "pushed body's own row": (SimConfig(capacity=16, **off), push_line([1e3, 1.0, 1e-3, 1e-6], [0, 1, 2, 3]),
                                  None),
        "head-on fracture at capacity 5,632": (SimConfig(capacity=sequential.MAX_CAPACITY, merge_time=0.0,
                                                         fracture_threshold=5.0), fracture_scene(), None),
        "4,096-body pile": (SimConfig(capacity=4096), lattice, lattice_timers),
    }


def sweep_inputs(cfg: SimConfig, sc: dict, timers, dev) -> tuple:
    """The positional inputs of `sequential.sweep` for a scene on `dev`
    (cfg placed there), its timers set."""
    st = scene.make_state(cfg, sc, dev)
    contact = st.contact if timers is None else torch.from_numpy(timers).to(dev)
    return (st.pos, st.vel, st.temp, st.mass, st.radius(cfg), inverse_mass(st.mass), st.mat, st.alive, contact)


def sweep_diff(got, want) -> tuple[float, bool, list]:
    """(max|kernel - plain| over the float outputs, bitwise, the fields whose
    relative error passes KERNEL_TOL or that differ where they must be
    exact)."""
    bad = [f for f in SEQ_EXACT_FIELDS if not torch.equal(getattr(got, f), getattr(want, f))]
    err, bitwise = 0.0, not bad
    for f in SEQ_FLOAT_FIELDS:
        x, y = getattr(got, f), getattr(want, f)
        bitwise = bitwise and torch.equal(x, y)
        e = float((x - y).abs().max()) if x.numel() else 0.0
        err = max(err, e)
        if e > KERNEL_TOL * max(float(y.abs().max()) if y.numel() else 0.0, 1e-30):
            bad.append(f)
    return err, bitwise, bad


def check_sweep(name: str, got, want) -> float:
    err, bitwise, bad = sweep_diff(got, want)
    c = {k: int(got.count(k)) for k in sequential.COUNTS}
    log(27, f"{name}: {'bitwise' if bitwise else f'max|kernel-plain|={err:.3e}'}; {c}")
    check(not bad, f"{name}: the sweep kernel against its plain version: {bad}")
    check(bitwise, f"{name}: the sweep kernel bitwise its plain version")
    return err


def sweep_bound(inputs, out) -> tuple[dict, dict]:
    """The card's bound of one sweep and one SM's (1/132 of the FP32 rate):
    its overlap tests' operations, its bodies' bytes, the [C, C] timers
    written once and each overlapping pair's timer read."""
    c = inputs[0].shape[0]
    ops = int(out.count("n_tests")) * SEQ_TEST_OPS
    nbytes = c * SEQ_BODY_BYTES + 4 * c * c + 4 * int((out.contact > 0).sum()) // 2
    return bound(ops, 0, nbytes), bound(ops * SMS, 0, nbytes)


def phase_sequential(dev, jacobi_ms: float, frames: int = 300, check_every: int = 50) -> dict:
    """Phase 27: the strict-sequential sweep kernel (csrc/collide_sequential.cu)
    against its plain version on the card, scene by scene, twice bitwise; the
    fracture scene through resolve_collisions_sequential on the card against
    the CPU with the same draws; then the reference scene at the reference's
    size through sim.run(collision_impl="sequential"), `frames` frames timed,
    one launch a substep, every `check_every`-th substep's sweep held against
    the plain version, one frame sync-checked. Returns the kernels line's
    entry."""
    err = 0.0
    for name, (cfg, sc, timers) in sequential_scenes().items():
        cfg = cfg.to(dev)
        inputs = sweep_inputs(cfg, sc, timers, dev)
        h = sim.substep_size(cfg)
        got = sequential.sweep(*inputs, h, cfg)
        err = max(err, check_sweep(f"{name} (C={cfg.capacity})", got, sequential.sweep_reference(*inputs, h, cfg)))
    check(sweep_diff(got, sequential.sweep(*inputs, h, cfg))[1], "the 4,096-body pile: two calls bitwise")
    b, b_sm = sweep_bound(inputs, got)
    pile_ms = cuda_ms(lambda: sequential.sweep(*inputs, h, cfg), 5)
    pile_stages = sweep_stage_ms(inputs, h, cfg, 5)
    log(27, f"4,096-body pile: a call {pile_ms:.4f} ms; the kernels alone (CUDA events) " + stages_text(pile_stages)
            + f"; {bound_text(b)}; one SM's {bound_text(b_sm)}")
    # the same lattice 4 apart: every row has near words and no pair
    # overlaps (the largest radius sum, two ice bodies', is 3.37), so the
    # walk's time is its rows' alone
    cfg = SimConfig(capacity=4096).to(dev)
    apart = sweep_inputs(cfg, lattice_pile(spacing=4.0)[0], None, dev)
    got = sequential.sweep(*apart, h, cfg)
    check_sweep("4,096-body lattice 4 apart (C=4096)", got, sequential.sweep_reference(*apart, h, cfg))
    check(int(got.count("n_bounces")) == 0, "the lattice 4 apart has no contact")
    apart_stages = sweep_stage_ms(apart, h, cfg, 5)
    log(27, "4,096-body lattice 4 apart: the kernels alone " + stages_text(apart_stages))
    with pytest_raises(ValueError):
        big = SimConfig(capacity=sequential.MAX_CAPACITY + 1)
        sequential.sweep(*sweep_inputs(big.to(dev), lattice_pile(2)[0], None, dev), h, big)
    log(27, f"capacity {sequential.MAX_CAPACITY + 1}: ValueError (the kernel takes at most {sequential.MAX_CAPACITY})")

    cfg, sc, timers = sequential_scenes()["head-on fracture"]
    gen = torch.Generator().manual_seed(5)
    draws = draw_fracture_uniforms(cfg, gen, "cpu")
    def resolve(where):
        c = cfg.to(where)
        st = scene.make_state(c, sc, where).replace(contact=torch.from_numpy(timers).to(where))
        return collisions.resolve_collisions_sequential(st, c, sim.substep_size(c), draws.to(where))

    (a, ea), (b_, eb) = resolve(dev), resolve(torch.device("cpu"))
    for f in ("n_merges", "n_fractures", "n_bounces", "n_evicted", "n_dropped"):
        check(int(getattr(ea, f)) == int(getattr(eb, f)), f"fracture scene: {f} equal on card and CPU")
    check(int(ea.n_fractures) > 0 and int(ea.spawn_mask.sum()) > 0, "fracture scene: fragments born")
    check(torch.equal(a.alive.cpu(), b_.alive) and torch.equal(a.seq.cpu(), b_.seq), "fracture scene: slots equal")
    for f in ("pos", "vel", "temp", "mass"):
        x, y = getattr(a, f).cpu(), getattr(b_, f)
        check(float((x - y).abs().max()) <= 1e-5 * float(y.abs().max()), f"fracture scene: {f} card vs CPU")
    log(27, f"head-on fracture through resolve_collisions_sequential, card vs CPU with the same draws: "
            f"{int(ea.n_fractures)} fractures, {int(ea.spawn_mask.sum())} fragments, counts and slots equal")

    # the reference scene at the reference's size, the sequential path
    cfg = SimConfig().to(dev)
    st = scene.make_state(cfg, scene.reference_galaxy(seed=0), dev, seed=0)
    st, _ = sim.step(st, cfg, collision_impl="sequential")  # warm-up
    torch.cuda.synchronize()
    kernel, recorded = sequential.sweep, []

    def recording(*args):
        # the wrapper counts its launches on `sequential.sweep`: this
        # stand-in, while it stands in
        out = kernel(*args)
        if (recording.launches - 1) % check_every == 0:
            recorded.append((tuple(x.clone() if isinstance(x, torch.Tensor) else x for x in args), out))
        return out

    recording.launches = 0  # the sequential frame step's path starts here
    sequential.sweep = recording
    try:
        t0 = time.perf_counter()
        st, evs = sim.run(st, cfg, frames, collision_impl="sequential")
        torch.cuda.synchronize()
        dt = time.perf_counter() - t0
    finally:
        sequential.sweep = kernel
    launches = recording.launches
    check(launches == frames * cfg.sub_steps, f"{launches} sweep launches in {frames} frames, one a substep")
    check(all_finite(st.pos, st.vel, st.acc, st.mass, st.temp, st.contact), f"state finite after {frames} frames")
    n_alive = int(st.n_alive)
    check(1 <= n_alive <= cfg.capacity, f"1 <= n_alive={n_alive} <= {cfg.capacity}")
    ms = dt / frames * 1e3
    log(27, f"reference scene, capacity 300, {frames} frames sequential: {ms:.3f} ms/frame (phase 3's Jacobi "
            f"{jacobi_ms:.3f}); {launches // frames / cfg.sub_steps:.0f} launch a substep; n_alive {n_alive}; "
            f"merges {int(evs.n_merges.sum())} fractures {int(evs.n_fractures.sum())} "
            f"bounces {int(evs.n_bounces.sum())} evicted {int(evs.n_evicted.sum())} dropped {int(evs.n_dropped.sum())}")
    for k, (args, out) in enumerate(recorded):
        want = sequential.sweep_reference(*args)
        err = max(err, check_sweep(f"reference scene, substep {k * check_every + 1}", out, want))
    check(len(recorded) == -(-frames * cfg.sub_steps // check_every), "every checked substep recorded")

    before = kernel.launches
    torch.cuda.set_sync_debug_mode("error")
    try:
        st, _ = sim.step(st, cfg, collision_impl="sequential")
    finally:
        torch.cuda.set_sync_debug_mode("default")
    torch.cuda.synchronize()
    check(kernel.launches - before == cfg.sub_steps, "the sweep ran in the sync-checked frame")
    log(27, "one sequential frame ran under set_sync_debug_mode('error'): no host sync in sim.step")

    args, out = recorded[-1]
    names, where = sweep_call_kernels(args), "this process"
    if not names:  # no profiler session of this process showed device events: a fresh process's
        cmd = [sys.executable, "-c", "import json, chip_smoke; print(json.dumps(chip_smoke.sweep_call_kernels()))"]
        proc = subprocess.run(cmd, capture_output=True, text=True, timeout=300)
        check(proc.returncode == 0, f"the sweep's kernels in a fresh process: {proc.stderr[-3000:]}")
        names, where = json.loads(proc.stdout.splitlines()[-1]), "a fresh process (the head-on fracture scene)"
    check(len(names) == 2 and "near_kernel" in names[0] and "walk_kernel" in names[1],
          f"a sweep call launches the pre-pass and the walk and nothing else (no fill): {names}")
    log(27, f"a call ran with torch's fills raising; its kernels (torch.profiler, {where}): {names}")
    k_ms = cuda_ms(lambda: kernel(*args), 20)
    plain_ms = cuda_ms(lambda: sequential.sweep_reference(*args), 1)
    b, b_sm = sweep_bound(args, out)
    stages = sweep_stage_ms(args[:9], args[9], args[10])
    log(27, f"sweep at the reference scene (C=300, {int(out.count('n_tests'))} overlap tests): a call {k_ms:.4f} ms "
            f"(the kernels alone on the device, CUDA events: {stages_text(stages)}), plain {plain_ms:.3f} ms; "
            f"{bound_text(b)}; one SM's {bound_text(b_sm)}; kernels/one SM's bound "
            f"{stages['both'] / b_sm['bound_ms']:.1f}")
    return dict(launches=launches, max_abs_err=err, ms=k_ms, plain_ms=plain_ms, **record(b), library_ms=None,
                bound_ms_one_sm=b_sm["bound_ms"], kernel_device_ms=stages["both"], prepass_ms=stages["pre-pass"],
                walk_ms=stages["walk"], ms_per_frame=ms, jacobi_ms_per_frame=jacobi_ms, ms_pile_4096=pile_ms,
                pile_kernels_ms=pile_stages["both"], pile_prepass_ms=pile_stages["pre-pass"],
                pile_walk_ms=pile_stages["walk"], apart_walk_ms=apart_stages["walk"])


def sweep_stage_ms(args: tuple, h: float, cfg: SimConfig, reps: int = 20) -> dict:
    """The device ms of a sweep's kernels on `args` (sweep's first nine),
    each launch between CUDA events queued behind a sleep kernel
    (bare_kernel_ms), so the wrapper's host work is not in the span: the
    pre-pass alone, the walk alone (on the scratch a pre-pass left), both."""
    c, dev = args[0].shape[0], args[0].device
    out, scratch = sequential._outputs(*args[:3], args[8], cfg, zeroed=False), sequential._scratch(c, dev)
    sequential._launch_into(out, scratch, args, h, cfg)
    return {name: bare_kernel_ms(lambda s=st: sequential._launch_into(out, scratch, args, h, cfg, s), reps)
            for name, st in (("pre-pass", sequential.PREPASS), ("walk", sequential.WALK),
                             ("both", sequential.BOTH))}


def stages_text(t: dict) -> str:
    return f"pre-pass {t['pre-pass']:.4f} ms, walk {t['walk']:.4f} ms, both {t['both']:.4f} ms"


@contextlib.contextmanager
def no_fills():
    """torch's fills (zeros, full, their _like forms, zero_, fill_) raise
    inside the block: a call that runs through launches no fill kernel."""
    def refuse(*args, **kwargs):
        raise RuntimeError("a fill inside a call that should launch none")

    names = [(torch, n) for n in ("zeros", "zeros_like", "full", "full_like")] + \
            [(torch.Tensor, n) for n in ("zero_", "fill_")]
    kept = [(owner, n, getattr(owner, n)) for owner, n in names]
    for owner, n, _ in kept:
        setattr(owner, n, refuse)
    try:
        yield
    finally:
        for owner, n, fn in kept:
            setattr(owner, n, fn)


def sweep_call_kernels(args=None) -> list[str]:
    """The device kernels of one sweep call on `args` (sweep's eleven; by
    default the head-on fracture scene on the card), by call_kernels, after
    the same call ran with torch's fills raising (no_fills)."""
    if args is None:
        cfg, sc, timers = sequential_scenes()["head-on fracture"]
        cfg = cfg.to("cuda")
        args = (*sweep_inputs(cfg, sc, timers, "cuda"), sim.substep_size(cfg), cfg)
    with no_fills():
        sequential.sweep(*args)
    return call_kernels(lambda: sequential.sweep(*args))


def call_kernels(call, tries: int = 3) -> list[str]:
    """The names of the device kernels one `call()` launches, in launch
    order, by torch.profiler: the first of `tries` profiled calls whose
    session shows device events (late in a long process a session has shown
    none; [] if none does)."""
    acts = [torch.profiler.ProfilerActivity.CPU, torch.profiler.ProfilerActivity.CUDA]
    cuda = torch.autograd.DeviceType.CUDA
    names = []
    for _ in range(tries):
        torch.cuda.synchronize()
        with torch.profiler.profile(activities=acts) as prof:
            call()
            torch.cuda.synchronize()
        names = [e.name for e in sorted((e for e in prof.events() if e.device_type == cuda),
                                        key=lambda e: e.time_range.start)]
        if names:
            break
    return names


def bare_kernel_ms(launch, reps: int = 20) -> float:
    """Median device ms of `launch()`, each between two CUDA events queued
    behind a ~1 ms sleep kernel: the span holds the kernel's run, not the
    host's time to enqueue it."""
    spans = []
    for _ in range(reps):
        start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        torch.cuda._sleep(2_000_000)
        start.record()
        launch()
        end.record()
        spans.append((start, end))
    torch.cuda.synchronize()
    return float(np.median([a.elapsed_time(b) for a, b in spans]))


@contextlib.contextmanager
def pytest_raises(exc):
    """Check that the block raises `exc`."""
    try:
        yield
    except exc:
        return
    raise RuntimeError(f"check failed: {exc.__name__} not raised")


# The bench's submesh (96, 24, 96) leaves 27 of the 1M scene's 29,054
# residuals past sub_k in the submesh's densest cells (a host census of the
# scene); phase 28 gates n_uncorrected == 0, so it keeps 128 a cell.
TWOLEVEL_SUB_K = 128
TWOLEVEL_SMALL = dict(g=32, n_cells=8, max_per_cell=64, eps=p3m_cluster.EPS, max_residual=2048,
                      residual_mode="twolevel", sub_g=36, sub_cells=12, sub_k=48, pp_impl="kernel")


def phase_twolevel(dev, dense_errs: dict, n: int = 1_000_000, n_core: int = 30_000, evals: int = 3) -> float:
    """Phase 28: p3m_acceleration(residual_mode="twolevel") on phase 9's
    scene at the production tune with the submesh (96, 24, TWOLEVEL_SUB_K): K4's
    main pass and K5 a call, no residual-residual launch; n_uncorrected 0;
    the core's and the field's median errors against the direct sum within
    3x phase 9's dense ones plus 1e-3; one evaluation sync-checked; the
    bench's main with `dense twolevel`; a 4,096-body evaluation on the card
    against the CPU. Returns ms per evaluation."""
    pos_np, mass_np, n_field = p3m_cluster.cluster_scene(n, n_core)
    pos, mass = torch.from_numpy(pos_np).to(dev), torch.from_numpy(mass_np).to(dev)
    tune, box = dict(p3m_cluster.mode_tune("twolevel"), sub_k=TWOLEVEL_SUB_K), p3m_cluster.BOX
    acc, unc = p3m.p3m_acceleration(pos, mass, 1.0, box, **tune)  # warm-up
    torch.cuda.synchronize()
    reset_pp_counts()  # the two-level path starts here
    uncs = []
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(evals):
        acc, unc = p3m.p3m_acceleration(pos, mass, 1.0, box, **tune)
        uncs.append(unc)
    end.record()
    end.synchronize()
    ms = start.elapsed_time(end) / evals
    k4, k5 = ppkernel.pp_short.launches, ppkernel.pp_react.launches
    check(k4 == evals and k5 == evals, f"{k4} K4 and {k5} K5 launches in {evals} evaluations, want {evals} each")
    n_unc = int(torch.stack(uncs).max())
    check(n_unc == 0, f"n_uncorrected {n_unc} == 0")
    check(all_finite(acc), "accelerations finite")
    errs = p3m_cluster.sample_errors(pos, mass, acc, n_field)
    log(28, f"N={n} core {n_core}, twolevel at {tune}: {ms:.3f} ms per evaluation over {evals}; K4 {k4 // evals} and "
            f"K5 {k5 // evals} launches per evaluation; n_uncorrected {n_unc}")
    log(28, f"median relative error vs direct sum (K1): twolevel {errs}; dense (phase 9) {dense_errs}")
    for part in ("core_median", "field_median"):
        check(errs[part] < 3 * dense_errs[part] + 1e-3,
              f"twolevel {part} {errs[part]:.3e} < 3 x dense {dense_errs[part]:.3e} + 1e-3")

    torch.cuda.set_sync_debug_mode("error")
    try:
        acc, unc = p3m.p3m_acceleration(pos, mass, 1.0, box, **tune)
    finally:
        torch.cuda.set_sync_debug_mode("default")
    torch.cuda.synchronize()
    check(int(unc) == 0 and ppkernel.pp_short.launches == evals + 1, "kernels ran in the sync-checked evaluation")
    log(28, "one twolevel evaluation ran under set_sync_debug_mode('error'): no host sync")
    del pos, mass, acc

    buf = io.StringIO()
    with contextlib.redirect_stdout(buf):
        rows = p3m_cluster.main([str(n), str(n_core), "dense", "twolevel"])
    print(buf.getvalue(), end="", flush=True)
    check([r["mode"] for r in rows] == ["dense", "twolevel"] and rows[0]["n_uncorrected"] == 0,
          "the bench's main: a line per mode, nothing uncorrected in dense")
    for r in rows:
        log(28, f"bench main {r['mode']}: {r['ms_per_eval']:.3f} ms per evaluation; n_uncorrected "
                f"{r['n_uncorrected']}; core {r['core_median']:.3e}, field {r['field_median']:.3e}")

    pos_np, mass_np, _ = p3m_cluster.cluster_scene(4096, 1024)
    (a, ua), (c, uc) = (p3m.p3m_acceleration(torch.from_numpy(pos_np).to(where), torch.from_numpy(mass_np).to(where),
                                             1.0, box, **TWOLEVEL_SMALL) for where in (dev, torch.device("cpu")))
    rel = float((a.cpu() - c).abs().max()) / float(c.abs().max())
    log(28, f"4,096 bodies (core 1,024) twolevel at {TWOLEVEL_SMALL}: card vs CPU max rel err {rel:.3e} (tol 1e-4); "
            f"n_uncorrected {int(ua)} and {int(uc)}")
    check(int(ua) == int(uc) == 0 and rel < 1e-4, "4,096-body twolevel: card against CPU")
    return ms


def phase_host_api(dev, capacity: int = 4096, n_disk: int = 3000) -> None:
    """Phase 29: the host API on the card. Simulation on phase 4's scene:
    run_checkpointed(40, every 10), Simulation.load, 10 more frames from
    the loaded copy and from the live one, bitwise (under
    torch.use_deterministic_algorithms, generator included); `python -m
    nbx_torch run --frames 50 --capacity 300`; StepTimer over 20 frames;
    profiling.trace writes its file; nan_guard passes a clean frame and
    raises at an injected NaN."""
    with tempfile.TemporaryDirectory() as tmp:
        path = os.path.join(tmp, "sim.npz")
        torch.use_deterministic_algorithms(True, warn_only=True)
        try:
            live = Simulation(SimConfig(capacity=capacity), scenario="galaxy", n_disk=n_disk, seed=0, device=dev)
            t0 = time.perf_counter()
            live.run_checkpointed(40, path, every=10)
            dt = time.perf_counter() - t0
            loaded = Simulation.load(path, device=dev)
            live.step(10)
            loaded.step(10)
        finally:
            torch.use_deterministic_algorithms(False)
        for f in ("pos", "vel", "acc", "mass", "temp", "mat", "alive", "seq", "next_seq", "step_count", "contact"):
            check(torch.equal(getattr(live.state, f), getattr(loaded.state, f)), f"resumed {f} bitwise")
        check(torch.equal(live.state.generator.get_state(), loaded.state.generator.get_state()),
              "resumed generator state equal")
        log(29, f"Simulation capacity {capacity}: 40 frames checkpointed every 10 in {dt:.2f} s "
                f"({os.path.getsize(path)} bytes a snapshot); loaded and live agree bitwise after 10 more frames")

        ckpt = os.path.join(tmp, "run.npz")
        cmd = [sys.executable, "-m", "nbx_torch", "run", "--frames", "50", "--capacity", "300", "--every", "25",
               "--checkpoint", ckpt]
        t0 = time.perf_counter()
        proc = subprocess.run(cmd, capture_output=True, text=True, timeout=600)
        log(29, f"{' '.join(cmd[1:])}: exit {proc.returncode} in {time.perf_counter() - t0:.1f} s: "
                f"{proc.stdout.strip()}")
        check(proc.returncode == 0 and "50 frames done" in proc.stdout and os.path.exists(ckpt),
              f"python -m nbx_torch run exits 0 ({proc.stderr[-2000:]})")

        s = Simulation(SimConfig(capacity=capacity), scenario="galaxy", n_disk=n_disk, seed=0, device=dev)
        s.step(2)  # warm-up
        timer = profiling.StepTimer()
        for _ in range(20):
            with timer:
                s.step(1)
                torch.cuda.synchronize()
        log(29, f"StepTimer, capacity {capacity}, 20 frames: {timer.summary()}")
        trace_dir = os.path.join(tmp, "trace")
        with profiling.trace(trace_dir):
            s.step(1)
        trace = os.path.join(trace_dir, "trace.json")
        check(os.path.getsize(trace) > 0, "profiling.trace wrote its file")
        log(29, f"profiling.trace: {os.path.getsize(trace)} bytes for one frame")

    cfg = SimConfig().to(dev)
    st = scene.make_state(cfg, scene.reference_galaxy(seed=0), dev, seed=0)
    with profiling.nan_guard():
        st, _ = sim.step(st, cfg)
    bad = st.replace(pos=st.pos.index_fill(0, torch.tensor([3], device=dev), float("nan")))
    with pytest_raises(FloatingPointError):
        with profiling.nan_guard():
            sim.step(bad, cfg)
    log(29, "nan_guard: a clean frame passes; an injected NaN raises FloatingPointError")


RENDER_W, RENDER_H = 640, 360  # the viewer's frame
RENDER_IMPOSTORS = 64
# one frame on the card against the CPU, with and without impostors: max|card - CPU| / max|CPU| of
# the frame. The impostor's rim normal sqrt(1 - d^2) is ill-conditioned (the CPU tests hold jitted
# `nbx` to 1e-3, tests/torch_parity.IMPOSTOR_FRAME_TOL), but the card's eager ops round as the CPU's
# but for their transcendental functions: 4.2e-5 with 64 impostors (NVIDIA H100 80GB HBM3, 700 W).
RENDER_TOL = 1e-4


def frame_events(marks) -> tuple[float, float]:
    """Mean device-stream ms of (physics, render) over (start, mid, end) CUDA
    event triples, one a frame."""
    torch.cuda.synchronize()
    return (float(np.mean([a.elapsed_time(b) for a, b, _ in marks])),
            float(np.mean([b.elapsed_time(c) for _, b, c in marks])))


def marks3():
    return tuple(torch.cuda.Event(enable_timing=True) for _ in range(3))


def to_cpu(x):
    """A tensor, dataclass or NamedTuple of tensors on the CPU."""
    if isinstance(x, torch.Tensor):
        return x.cpu()
    if hasattr(x, "_asdict"):
        return type(x)(*(to_cpu(v) for v in x))
    return type(x)(**{f.name: to_cpu(getattr(x, f.name)) for f in dataclasses.fields(x)})


def render_vs_cpu(dev, st, cfg, ev, fr, cam, stars, n_impostors: int, granular_trails=None) -> float:
    """One frame of render_and_advance (or render_granular with trail slots)
    on the card and on the CPU from the same state, events, renderer state
    and particle draws: max|card - CPU| / max|CPU| of the frame; the particle
    slots must agree."""
    gen = torch.Generator().manual_seed(3)
    n = st.pos.shape[0]
    f = int(ev.spawn_mask.numel())
    draws = pipeline.FrameDraws(particles.draw_smoke(gen, n, fr.particles.life.shape[0], "cpu"),
                                particles.draw_explosions(gen, f, "cpu"))
    fr_cpu = convert.frame_state_from_arrays(convert.frame_state_to_arrays(fr), "cpu")
    cam_cpu = splat.Camera(cam.eye.cpu(), cam.target.cpu(), cam.up.cpu(), cam.fov_deg)
    kw = dict(width=RENDER_W, height=RENDER_H, stars=stars, n_impostors=n_impostors)
    card_draws = pipeline.FrameDraws(draws.smoke.to(dev), draws.explosions.to(dev))
    if granular_trails is None:
        cfg_cpu = SimConfig(**{k.name: getattr(cfg, k.name) for k in dataclasses.fields(cfg) if k.name != "materials"})
        st_cpu = convert.state_from_arrays(convert.state_to_arrays(st), cfg_cpu, "cpu")
        fa, a = pipeline.render_and_advance(fr, st, cfg, ev, cam, draws=card_draws, **kw)
        kw["stars"] = stars.cpu()
        fb, b = pipeline.render_and_advance(fr_cpu, st_cpu, cfg_cpu, to_cpu(ev), cam_cpu, draws=draws, **kw)
    else:
        cfg_cpu = cfg.to("cpu")
        st_cpu = convert.granular_state_from_arrays(convert.granular_state_to_arrays(st), "cpu")
        fa, a = pipeline.render_granular(fr, st, cfg, ev, cam, granular_trails, draws=card_draws, **kw)
        kw["stars"] = stars.cpu()
        fb, b = pipeline.render_granular(fr_cpu, st_cpu, cfg_cpu, to_cpu(ev), cam_cpu, granular_trails.cpu(),
                                         draws=draws, **kw)
    check(torch.equal(fa.particles.life.cpu() > 0, fb.particles.life > 0), "particle slots equal on card and CPU")
    return float((a.cpu() - b).abs().max()) / max(float(b.abs().max()), 1e-30)


def render_profile(fr, st, cfg, ev, cam, kw) -> None:
    """Log one render_and_advance's kernels and device time by torch.profiler
    against its host time: whether the render waits on the host."""
    acts = [torch.profiler.ProfilerActivity.CPU, torch.profiler.ProfilerActivity.CUDA]
    with torch.profiler.profile(activities=acts) as prof:
        t0 = time.perf_counter()
        pipeline.render_and_advance(fr, st, cfg, ev, cam, **kw)
        torch.cuda.synchronize()
        wall = (time.perf_counter() - t0) * 1e3
    # kernels only: an operator's entry also sums its kernels' device time
    dev_events = [e for e in prof.key_averages()
                  if e.device_time_total > 0 and str(getattr(e, "device_type", "")).endswith("CUDA")]
    busy = sum(e.device_time_total for e in dev_events) / 1e3
    kernels = sum(e.count for e in dev_events)
    top = sorted(dev_events, key=lambda e: -e.device_time_total)[:4]
    if not dev_events:
        log(30, f"render profile: {wall:.3f} ms on the host; the profiler saw no device time (not measured)")
        return
    log(30, f"render profile, one frame: {wall:.3f} ms wall, {kernels} kernels, {busy:.3f} ms device busy "
            f"(share {busy / wall:.3f}); top: " + "; ".join(f"{e.key[:40]} {e.device_time_total / 1e3:.3f} ms "
                                                          f"x{e.count}" for e in top))


def phase_render(dev, scaled_ms: float, frames: int = 300, scaled_frames: int = 60, scaled_n: int = SCALED_N) -> dict:
    """Phase 30: the renderer on the card. The reference galaxy (capacity
    300) through sim.step and render_and_advance at 640x360 with 64
    impostors, bloom and the starfield for `frames` frames, physics and
    render timed apart by CUDA events; one frame under
    set_sync_debug_mode("error"); one frame against the CPU with the same
    state, events and draws (with and without impostors). Then the
    at-scale 131,072-body cloud's served frame, `BigLiveSim._advance_and_render`
    (phase 7's configuration, re-sized after a late readback shows an
    overflow; every re-sized layout's first frame must count none), timed
    beside phase 7's step alone, with render_granular alone on one state;
    one frame of its step and render sync-checked and one against the CPU."""
    cfg = SimConfig().to(dev)
    st = scene.make_state(cfg, scene.reference_galaxy(seed=0), dev, seed=0)
    fr = pipeline.FrameState.create(cfg.capacity, cfg.trail_length, device=dev)
    cam = splat.Camera.default(dev)
    stars = pipeline.starfield_directions(device=dev)
    kw = dict(width=RENDER_W, height=RENDER_H, stars=stars, n_impostors=RENDER_IMPOSTORS)
    for _ in range(2):  # warm-up: allocator, constants
        st, ev = sim.step(st, cfg)
        fr, img = pipeline.render_and_advance(fr, st, cfg, ev, cam, **kw)
    torch.cuda.synchronize()
    marks = []
    t0 = time.perf_counter()
    for _ in range(frames):
        a, b, c = marks3()
        a.record()
        st, ev = sim.step(st, cfg)
        b.record()
        fr, img = pipeline.render_and_advance(fr, st, cfg, ev, cam, **kw)
        c.record()
        marks.append((a, b, c))
    torch.cuda.synchronize()
    frame_ms = (time.perf_counter() - t0) / frames * 1e3
    phys_ms, render_ms = frame_events(marks)
    check(tuple(img.shape) == (RENDER_H, RENDER_W, 3) and all_finite(img), "frame finite, 640x360")
    check(float(img.min()) >= 0.0 and float(img.max()) <= 1.0 and float(img.max()) > 0.0, "frame in [0, 1], lit")
    log(30, f"reference galaxy, capacity 300, {frames} frames at {RENDER_W}x{RENDER_H}, {RENDER_IMPOSTORS} "
            f"impostors, bloom, {pipeline.N_STARS} stars: {frame_ms:.3f} ms/frame; physics {phys_ms:.3f} ms, render "
            f"{render_ms:.3f} ms a frame (CUDA events); particles alive {int(fr.particles.n_alive)}, lights "
            f"{int((fr.lights.intensity > 0).sum())}")
    torch.cuda.set_sync_debug_mode("error")
    try:
        st, ev = sim.step(st, cfg)
        fr2, img = pipeline.render_and_advance(fr, st, cfg, ev, cam, **kw)
    finally:
        torch.cuda.set_sync_debug_mode("default")
    torch.cuda.synchronize()
    log(30, "one frame (step and render) ran under set_sync_debug_mode('error'): no host sync")
    render_profile(fr, st, cfg, ev, cam, kw)
    err_imp = render_vs_cpu(dev, st, cfg, ev, fr, cam, stars, RENDER_IMPOSTORS)
    err_plain = render_vs_cpu(dev, st, cfg, ev, fr, cam, stars, 0)
    log(30, f"one frame card vs CPU, same state, events and draws: max rel err {err_plain:.3e} without impostors, "
            f"{err_imp:.3e} with {RENDER_IMPOSTORS} (tol {RENDER_TOL:g})")
    check(err_plain < RENDER_TOL and err_imp < RENDER_TOL, "the frame on the card against the CPU")

    # the at-scale viewer's frame as the server makes it: BigLiveSim's own
    # _advance_and_render (phase 7's configuration, its thread not started),
    # with its re-size after a late readback shows an overflow
    from nbx_torch.serve import BigLiveSim

    live = BigLiveSim(n=scaled_n, device=dev)
    layouts, read = [], []  # the layout each frame ran on; each call's n_overflow, the frame before's

    def served_frame():
        img = live._advance_and_render()
        layouts.append(live.n_resizes)
        read.append(live.n_overflow)
        return img

    for _ in range(2):  # warm-up: allocator, cuFFT plans, constants
        served_frame()
    torch.cuda.synchronize()
    collide.collide_fused.launches = 0  # the at-scale viewer's frames from here
    t0 = time.perf_counter()
    for _ in range(scaled_frames):
        gimg = served_frame()
    torch.cuda.synchronize()
    dt = time.perf_counter() - t0
    k2 = collide.collide_fused.launches
    overflow = read[1:]  # overflow[f]: frame f's count, read back during frame f + 1
    firsts = [overflow[f] for f in range(1, len(overflow)) if layouts[f] != layouts[f - 1]]
    check(live.n_resizes > 0, "at-scale frames: the collapsing cloud overflowed a layout and was re-sized")
    check(all(v == 0 for v in firsts), f"at-scale frames: n_overflow on each re-sized layout's first frame {firsts}")
    check(k2 > 0 and live.n_errors == 0, f"at-scale frames: K2 launched ({k2})")
    check(all_finite(live.state.pos, gimg), "at-scale state and frame finite")
    gcfg, box = live.cfg, live.box
    skw = dict(n_cells=live.g_c, band_cells=live.band, buckets=live.buckets, force_impl=live.force_impl,
               pm_grid=live.pm_grid, log_events=True, green_hat=live.green_hat)
    gkw = dict(width=live.width, height=live.height, stars=live.stars, n_impostors=RENDER_IMPOSTORS)
    torch.cuda.set_sync_debug_mode("error")
    try:
        gst, _, gev = collisions_scaled.granular_full_kdk_scan(live.state, gcfg, box, 1, **skw)
        gfr2, gimg = pipeline.render_granular(live.frame_state, gst, gcfg, gev, live.cam, live.trail_idx, **gkw)
    finally:
        torch.cuda.set_sync_debug_mode("default")
    torch.cuda.synchronize()
    log(30, "one at-scale frame (step and render) ran under set_sync_debug_mode('error'): no host sync")
    marks = []
    for _ in range(10):  # the render alone, on one state: its share of the frame
        a, _, c2 = marks3()
        a.record()
        pipeline.render_granular(live.frame_state, gst, gcfg, gev, live.cam, live.trail_idx, **gkw)
        c2.record()
        marks.append((a, c2))
    torch.cuda.synchronize()
    g_render = float(np.mean([a.elapsed_time(c2) for a, c2 in marks]))
    log(30, f"at-scale cloud N={live.n}, {scaled_frames} frames of BigLiveSim._advance_and_render (the served "
            f"frame, counters read back a frame late, re-sizes included): {dt / scaled_frames * 1e3:.3f} ms/frame "
            f"(phase 7's step alone {scaled_ms:.3f} ms); render_granular alone {g_render:.3f} ms (CUDA events); "
            f"K2 {k2} launches; {live.n_resizes} re-sizes after an overflow, n_overflow per frame "
            f"{overflow}, on each re-sized layout's first frame {firsts}")
    g_err = render_vs_cpu(dev, gst, gcfg, gev, live.frame_state, live.cam, live.stars, RENDER_IMPOSTORS,
                          granular_trails=live.trail_idx)
    log(30, f"one at-scale frame card vs CPU: max rel err {g_err:.3e} (tol {RENDER_TOL:g}, with impostors)")
    check(g_err < RENDER_TOL, "the at-scale frame on the card against the CPU")
    return dict(ms_frame=frame_ms, physics_ms=phys_ms, render_ms=render_ms, scaled_ms_frame=dt / scaled_frames * 1e3,
                scaled_render_ms=g_render)


SERVE_SECONDS = 10.0


def free_port() -> int:
    import socket

    with socket.socket() as sock:
        sock.bind(("127.0.0.1", 0))
        return sock.getsockname()[1]


def http_get(url: str, timeout: float = 30.0):
    import urllib.request

    with urllib.request.urlopen(url, timeout=timeout) as r:
        return r.status, r.read(), r.headers.get("Content-Type")


def phase_serve(dev, seconds: float = SERVE_SECONDS, big_n: int = SCALED_N) -> dict:
    """Phase 31: `serve.serve` on the card, in-process on a free localhost
    port, for the reference galaxy (LiveSim) and the 131,072-body cloud
    (BigLiveSim, `--big`): every endpoint answers (/, /frame.png, /stream,
    /state, /spawn, /orbit, /set, /resize, /reset), frames encoded a second
    and /frame.png latency over `seconds`; no frame raised, from the first
    frame to the frames after /reset (LiveSim's n_errors, never cleared, and
    /state's)."""
    import threading

    from nbx_torch import serve as serve_mod

    out = {}
    for big in (0, big_n):
        name = f"serve --big {big}" if big else "serve"
        collide.collide_fused.launches = 0  # this server's launches from here
        port = free_port()
        httpd, live = serve_mod.serve(port, block=False, big_n=big)
        threading.Thread(target=httpd.serve_forever, daemon=True).start()
        base = f"http://127.0.0.1:{port}"
        try:
            t0 = time.perf_counter()
            while not live.frame_png and not live.n_errors and time.perf_counter() - t0 < 300:
                time.sleep(0.05)
            check(live.n_errors == 0 and bool(live.frame_png), f"{name}: first frame ({live.first_error})")
            first_s = time.perf_counter() - t0
            code, body, ctype = http_get(base + "/")
            check(code == 200 and ctype == "text/html" and b"drawPreview" in body, f"{name}: /")
            spawn = json.loads(http_get(base + "/spawn?sx0=300&sy0=200&sx1=340&sy1=210")[1])
            # the cloud starts with no dead slot: a big spawn may be dropped (counted, never evicted)
            check(spawn["spawned"] in ((0, 1) if big else (True,)) and not spawn["evicted"],
                  f"{name}: /spawn ({spawn})")
            http_get(base + "/orbit?dyaw=0.05&dpitch=0.02&zoom=1.02")
            check(json.loads(http_get(base + "/set?G=0.55&bloom_strength=1.1")[1])["set"]["G"] == 0.55,
                  f"{name}: /set")
            check(json.loads(http_get(base + "/resize?w=640&h=360")[1]) == {"width": 640, "height": 360},
                  f"{name}: /resize")
            import urllib.request

            with urllib.request.urlopen(base + "/stream", timeout=60) as r:
                data = b""
                while data.count(b"--nbxframe") < 3:
                    data += r.read(65536)
            check(data.count(b"\x89PNG") >= 2, f"{name}: /stream pushed frames")
            lat, states = [], []
            seq0, t0 = live.frame_seq, time.perf_counter()
            while time.perf_counter() - t0 < seconds:
                a = time.perf_counter()
                code, body, ctype = http_get(base + "/frame.png")
                lat.append((time.perf_counter() - a) * 1e3)
                check(code == 200 and ctype == "image/png" and body[:4] == b"\x89PNG", f"{name}: /frame.png")
                if len(lat) % 20 == 0:
                    states.append(json.loads(http_get(base + "/state")[1]))
                time.sleep(0.02)
            elapsed = time.perf_counter() - t0
            rate = (live.frame_seq - seq0) / elapsed
            s = json.loads(http_get(base + "/state")[1])
            check(s["error"] is None and s["n_errors"] == 0 and all(x["n_errors"] == 0 for x in states),
                  f"{name}: /state shows {s['n_errors']} frames that raised, the first {s['first_error']}")
            check(s["step"] > 0 and s["alive"] > 0, f"{name}: /state steps ({s})")
            extra = ""
            if big:
                extra = (f"; counters bounces {s['n_bounces']} merges {s['n_merges']} fractures {s['n_fractures']}; "
                         f"n_overflow {s['n_overflow']}, {s['n_resizes']} re-sizes (phase 30 holds each re-sized "
                         f"layout's first frame to 0); K2 launches {collide.collide_fused.launches}")
                check(collide.collide_fused.launches > 0, f"{name}: K2 launched")
            check(json.loads(http_get(base + "/reset?scenario=" + ("cloud" if big else "galaxy"))[1]) == {},
                  f"{name}: /reset")
            log(31, f"{name}: first frame after {first_s:.1f} s; {rate:.2f} frames encoded a second over "
                    f"{elapsed:.1f} s (the server paces at 30 a second); /frame.png latency median "
                    f"{np.median(lat):.2f} ms, p90 {np.percentile(lat, 90):.2f} ms over {len(lat)} requests; "
                    f"/state step {s['step']} alive {s['alive']} energy {s['energy']:.4g}{extra}")
            out[name] = dict(fps=rate, png_ms=float(np.median(lat)))
            seq = live.frame_seq
            t0 = time.perf_counter()
            while live.frame_seq < seq + 2 and time.perf_counter() - t0 < 60:  # frames of the reset scene
                time.sleep(0.05)
        finally:
            httpd.shutdown()
            live.stop()
        check(live.n_errors == 0 and live.frame_seq >= seq + 2,
              f"{name}: {live.n_errors} frames raised while it served, the first {live.first_error}")
    return out


@contextlib.contextmanager
def launcher_env(**env):
    """The launcher variables of a world of one (None: unset), the whole
    environment's values of them restored after."""
    old = {k: os.environ.get(k) for k in env}
    for k, v in env.items():
        if v is None:
            os.environ.pop(k, None)
        else:
            os.environ[k] = str(v)
    try:
        yield
    finally:
        for k, v in old.items():
            if v is None:
                os.environ.pop(k, None)
            else:
                os.environ[k] = v


def phase_multihost(dev, n: int = HEADLINE_N, steps: int = 10, n_cloud: int = SCALED_N) -> dict:
    """Phase 32: the multi-host entry at one card. `multihost.initialize`
    from WORLD_SIZE=1, RANK=0, LOCAL_RANK=0 (NCCL), `make_host_mesh`,
    `shard_state_multihost` of the 262,144-body merger, `steps` sharded steps
    (K1) with the all-reduced energy; `save_sharded` / `load_sharded`
    bitwise; `render_sharded` and `render_spatial` at D = 1 against the
    single-device splat (deterministic scatters: bitwise)."""
    import torch.distributed as dist

    from nbx_torch.parallel import multihost

    with launcher_env(WORLD_SIZE=1, RANK=0, LOCAL_RANK=0, MASTER_PORT=None):
        multihost.initialize(device=dev)
    try:
        multihost.initialize(device=dev)  # idempotent
        backend = "nccl" if torch.device(dev).type == "cuda" else "gloo"
        check(dist.get_backend() == backend and dist.get_world_size() == 1, f"{backend} world of one")
        mesh = multihost.make_host_mesh()
        sc = scene.galaxy_merger(n=n, seed=0)
        st = multihost.shard_state_multihost(mesh, sc["pos"], sc["vel"], sc["mass"])
        step = shard.make_sharded_step(mesh)
        G, eps, h = 0.5, 0.5, 0.02
        st = step(st, G, eps, h)  # warm-up
        torch.cuda.synchronize()
        pairwise_acc.launches = 0  # the multi-host step's path from here
        t0 = time.perf_counter()
        st, _ = shard.run_sharded(st, step, G, eps, h, steps)
        ke, pe = shard.sharded_energy(mesh, st, G, eps)
        torch.cuda.synchronize()
        ms = (time.perf_counter() - t0) / steps * 1e3
        check(pairwise_acc.launches == steps, f"K1 called {pairwise_acc.launches} times in {steps} steps")
        check(all_finite(st.pos, st.vel, ke, pe), "sharded state and energy finite")
        log(32, f"initialize (NCCL, WORLD_SIZE=1), make_host_mesh {mesh.mesh.tolist()}, shard_state_multihost of the "
                f"{n}-body merger: {steps} sharded steps {ms:.3f} ms/step (and the energy), K1 {pairwise_acc.launches} "
                f"calls; E = {float(ke + pe):.6e}")
        with tempfile.TemporaryDirectory() as tmp:
            t0 = time.perf_counter()
            checkpoint.save_sharded(tmp, st, mesh)
            back = checkpoint.load_sharded(tmp, mesh)
            ck_s = time.perf_counter() - t0
            size = sum(os.path.getsize(os.path.join(tmp, f)) for f in os.listdir(tmp))
        check(all(torch.equal(a, b) for a, b in zip(st, back)), "save_sharded / load_sharded bitwise")
        log(32, f"save_sharded + load_sharded: bitwise, {size} bytes, {ck_s:.2f} s")
        cam = splat.Camera(torch.tensor([0.0, 220.0, 420.0], device=dev), torch.zeros(3, device=dev),
                           torch.tensor([0.0, 1.0, 0.0], device=dev))
        mats = SimConfig().materials.to(dev)
        ones = torch.ones(n, dtype=torch.bool, device=dev)
        torch.use_deterministic_algorithms(True, warn_only=True)
        try:
            img = shard.render_sharded(mesh, st, cam)
            ref = tonemap(splat.splat_bodies_hdr(st.pos, torch.pow(st.mass, 1.0 / 3.0) * 0.8,
                                                 torch.zeros(n, device=dev), torch.zeros(n, dtype=torch.int32,
                                                                                         device=dev),
                                                 ones, mats.color1, mats.color2, cam), 4.0)
            check(torch.equal(img, ref), "render_sharded at D = 1 is the single-device splat")
            pos, vel, mass = granular_cloud(n_cloud, seed=0)
            cfg = SimConfig().to(dev)
            sst = spatial.spatial_state_for(mesh, pos, vel, mass, BOX, 40)
            gcam = splat.Camera(torch.tensor([50.0, 110.0, 210.0], device=dev), torch.full((3,), 50.0, device=dev),
                                torch.tensor([0.0, 1.0, 0.0], device=dev))
            simg = spatial.render_spatial(mesh, sst, cfg, gcam)
            sref = tonemap(splat.splat_bodies_hdr(sst.pos, body_radius(sst.mass, sst.mat, cfg.materials), sst.temp,
                                                  sst.mat, sst.mass > 0, cfg.materials.color1, cfg.materials.color2,
                                                  gcam), 4.0)
            check(torch.equal(simg, sref) and float(simg.max()) > 0, "render_spatial at D = 1 is the single-device "
                                                                     "splat")
        finally:
            torch.use_deterministic_algorithms(False)
        log(32, f"render_sharded ({n} bodies) and render_spatial (the {n_cloud}-body cloud) at D = 1: bitwise the "
                f"single-device splat (deterministic scatters)")
        return dict(ms_step=ms)
    finally:
        dist.destroy_process_group()


def phase_demos(frames_galaxy: int = 30, merger_n: int = SCALED_N, frames_merger: int = 10, device: str = "cuda") -> None:
    """Phase 33: `python -m nbx_torch demo galaxy` and `demo merger` as
    subprocesses: exit 0, their PNGs exist and are non-empty."""
    with tempfile.TemporaryDirectory() as tmp:
        for args, want in ((["galaxy", str(frames_galaxy), os.path.join(tmp, "galaxy")], -(-frames_galaxy // 4)),
                           (["merger", str(merger_n), str(frames_merger), os.path.join(tmp, "merger")],
                            -(-frames_merger // 2))):
            cmd = [sys.executable, "-m", "nbx_torch", "demo", *args, "--device", device]
            t0 = time.perf_counter()
            proc = subprocess.run(cmd, capture_output=True, text=True, timeout=600)
            dt = time.perf_counter() - t0
            out = args[-1]
            pngs = sorted(f for f in os.listdir(out) if f.endswith(".png")) if os.path.isdir(out) else []
            sizes = [os.path.getsize(os.path.join(out, f)) for f in pngs]
            log(33, f"demo {' '.join(args[:-1])}: exit {proc.returncode} in {dt:.1f} s; {len(pngs)} PNGs, "
                    f"{min(sizes, default=0)}-{max(sizes, default=0)} bytes; {proc.stdout.strip()[-300:]}")
            check(proc.returncode == 0, f"demo {args[0]} exits 0 ({proc.stderr[-2000:]})")
            check(len(pngs) == want and min(sizes) > 1000, f"demo {args[0]}: {want} non-empty PNGs")
            if args[0] == "galaxy":
                check(os.path.getsize(os.path.join(out, "player.html")) > 0, "demo galaxy: the HTML player")


def main() -> None:
    t0 = time.perf_counter()
    name = phase_device()
    dev = torch.device("cuda", 0)
    phase_build()
    k1 = phase_kernel(dev)
    jacobi_ms = phase_reference(dev)
    phase_full_physics(dev)  # resets the launch count: the frame step's path starts here
    phase_headline(dev)
    k1_launches = pairwise_acc.launches
    k2 = phase_collide_kernel(dev)
    scaled_ms = phase_scaled(dev)  # resets the launch counts: the at-scale path starts here
    k2_launches = collide.collide_fused.launches
    phase_scaled_vs_cpu(dev)
    err4, err5 = phase_pp_kernels(dev)
    _, dense_errs = phase_p3m(dev)  # resets the K4/K5 counts: P3M's path
    # resets them again: the merger step's path, whose shapes the K4 and K5
    # entries' times, errors and bounds come from
    _, (_, k4_launches, k5_launches), k4, k5 = phase_merger(dev)
    phase_merger_vs_cpu(dev)
    k4["max_abs_err"] = max(k4["max_abs_err"], err4)
    k5["max_abs_err"] = max(k5["max_abs_err"], err5)
    t10 = time.perf_counter()
    k6, k3 = phase_gravity_kernels(dev)
    kdk_energies, k3_launches, _ = phase_drift_gate(dev)  # resets K1's and K3's counts: the drift gate's path
    k6_launches, _ = phase_hermite(dev, kdk_energies)  # resets K6's count: the Hermite path
    phase_bench(dev)
    t14 = time.perf_counter()
    k8, err2 = phase_layouts(dev)
    k2["max_abs_err"] = max(k2["max_abs_err"], err2)
    k2m, k2m_launches = phase_multi_window(dev)  # resets K2m's count: the bench's u0.8x4 path
    k8_launches = phase_layout_benches(dev)  # resets K8's count: the layout bench's path
    t17 = time.perf_counter()
    k7 = phase_grav_kernel(dev)
    with shard.local_world("cpu:gloo,cuda:nccl"):
        k7_launches = phase_spatial(dev)  # resets K7's count: the spatial step's p3m path
        spatial_rows = phase_spatial_bench(dev)
        t20 = time.perf_counter()
        k2s = phase_slab_kernel(dev)
        phase_sharded_gravity(dev)
        phase_sharded_physics(dev)
        k2s_launches = phase_sharded_granular(dev, spatial_rows)  # resets the slab kernel's count: its pm path
    t24 = time.perf_counter()
    variants = phase_precisions(dev)  # resets each variant's count: its drift path
    t25 = time.perf_counter()
    probes = phase_probes(dev)  # resets K2's count before each probe's main: its path
    t26 = time.perf_counter()
    seq = phase_sequential(dev, jacobi_ms)  # resets the sweep's count: the sequential frame step's path
    t27 = time.perf_counter()
    phase_twolevel(dev, dense_errs)  # resets the K4/K5 counts: the two-level P3M path
    t28 = time.perf_counter()
    phase_host_api(dev)
    t29 = time.perf_counter()
    phase_render(dev, scaled_ms)  # resets K2's count: the at-scale viewer's frames
    t30 = time.perf_counter()
    phase_serve(dev)  # resets K2's count before each server: its frames
    t31 = time.perf_counter()
    phase_multihost(dev)  # resets K1's count: the multi-host step
    t32 = time.perf_counter()
    phase_demos()
    t33 = time.perf_counter()
    print(f"[done] every phase passed: {t33 - t0:.1f} s in all, phases 11-14 {t14 - t10:.1f} s, "
          f"phases 15-17 {t17 - t14:.1f} s, phases 18-20 {t20 - t17:.1f} s, phases 21-24 {t24 - t20:.1f} s, "
          f"phase 25 {t25 - t24:.1f} s, phase 26 {t26 - t25:.1f} s, phase 27 {t27 - t26:.1f} s, "
          f"phase 28 {t28 - t27:.1f} s, phase 29 {t29 - t28:.1f} s, phase 30 {t30 - t29:.1f} s, "
          f"phase 31 {t31 - t30:.1f} s, phase 32 {t32 - t31:.1f} s, phase 33 {t33 - t32:.1f} s", flush=True)
    records = [
        dict(name="pairwise_f32r", route="cuda", source="nbx_torch/csrc/pairwise_f32r.cu",
             replaces="nbx/ops/pairwise.py:168", launches=k1_launches, **k1),
        dict(name="collide_fused", route="cuda", source="nbx_torch/csrc/collide_fused.cu",
             replaces="nbx/ops/collide.py:236", launches=k2_launches, **k2),
        dict(name="collide_full_column", route="cuda", source="nbx_torch/csrc/collide_fused.cu",
             replaces="nbx/ops/collide.py:112", launches=k8_launches, **k8),
        dict(name="collide_fused_multi", route="cuda", source="nbx_torch/csrc/collide_fused.cu",
             replaces="nbx/ops/collide.py:242", launches=k2m_launches, **k2m),
        dict(name="pp_short", route="cuda", source="nbx_torch/csrc/pp_short.cu",
             replaces="nbx/ops/ppkernel.py:59", launches=k4_launches, **k4),
        dict(name="pp_react", route="cuda", source="nbx_torch/csrc/pp_react.cu",
             replaces="nbx/ops/ppkernel.py:143", launches=k5_launches, **k5),
        dict(name="pairwise_accjerk", route="cuda", source="nbx_torch/csrc/pairwise_accjerk.cu",
             replaces="nbx/ops/pairwise.py:573", launches=k6_launches, **k6),
        dict(name="potential", route="cuda", source="nbx_torch/csrc/potential.cu",
             replaces="nbx/ops/pairwise.py:682", launches=k3_launches, **k3),
        dict(name="collide_fused_grav", route="cuda", source="nbx_torch/csrc/collide_fused.cu",
             replaces="nbx/ops/collide.py:261", launches=k7_launches, **k7),
        dict(name="collide_fused_slab", route="cuda", source="nbx_torch/csrc/collide_fused.cu",
             replaces="nbx/ops/collide.py:1913", launches=k2s_launches, **k2s),
    ] + [dict(name=f"pairwise_{p}", route="cuda",
              source=f"nbx_torch/csrc/{pairwise.VARIANT_KERNEL[p][0]}.cu",
              replaces=f"nbx/ops/pairwise.py:{VARIANT_SITE[p]}", **variants[p]) for p in VARIANTS
    ] + [dict(name=f"collide_fused_{p}", route="cuda", source="nbx_torch/csrc/collide_fused.cu",
              replaces=site, launched_by=f"nbx_torch/bench/{p}.py", **probes[p]) for p, site in PROBE_SITES.items()
    ] + [dict(name="collide_sequential", route="cuda", source="nbx_torch/csrc/collide_sequential.cu",
              replaces="nbx/collisions.py:350", replaces_note="the fori_loop of resolve_collisions_sequential; "
              "no pl.pallas_call", **seq)]
    print(json.dumps({"kernels": records}), flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": name, "count": torch.cuda.device_count()}}), flush=True)


if __name__ == "__main__":
    main()
