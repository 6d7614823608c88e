// Fused collision pass over window descriptors, float32, for NVIDIA Hopper
// (sm_90a).
//
// Replaces four TPU kernels of nbx/ops/collide.py, as the layouts of
// `binned_collision_pass` and the spatial step's local entries launch them:
// `_collide_kernel_fused` (:236, body `_collide_fused_body` :280; the
// bucketed, banded, band-packed and compacted layouts), `_collide_kernel`
// (:112, the full-column layout: a column against its 9 neighbour columns in
// 9 scalar-prefetch-driven revisits that merge into one output block),
// `_collide_kernel_fused_multi` (:242, several windows per program) and
// `_collide_kernel_fused_grav` (:261, the P3M short-range gravity summed over
// the same lanes, below). It keeps those kernels' contract, not their blocks:
// for every target body of a window, against the window's fused source lanes
// (9 neighbour-column strips, each cut to its kept length, then masked by the
// symmetric-drop mask), it sums
//
//   dv  = -(1/m_i) sum (a2 d - ft rv),     a2 = (j + ft vn) / dist
//   dp  = -(1/m_i) sum c2 d,               c2 = (min_d - dist)/dist * 0.8 mu
//   heat = 0.2 (1/m_i) sum 1/2 vn (mu vn)  (approaching pairs only)
//   n_bounce = number of approaching overlapping pairs
//
// with mu = m_i m_j / (m_i + m_j) (one reciprocal per pair), j = -(1+e) mu vn
// and ft = friction * mu, and picks the deepest-overlap partner: the largest
// min_d - dist over overlapping pairs, ties to the smallest body id. A pair
// overlaps when both masses are > 0, the ids differ, and r^2 < min_d^2. K8's
// own arithmetic (two reciprocals, normalised normals and tangents) is the
// same physics; its pair set and partner rule are the same, so a full column
// is one window here: its targets against its 9 neighbour columns' kept
// bodies, in a single visit.
//
// Bound: a lane costs the overlap test, 11 FP32 operations on a staged row
// (3 differences, r^2, r_i + r_j and its square); only overlapping pairs, a
// few per target, take the rest (one rsqrtf, one division, ~40 FP32 ops). So
// the kernel is bound by FP32 issue on the overlap test; the TPU kernel
// evaluated the whole pair math on every padded lane instead.
//
// Design. A window's fused lanes are cut into runs of kRun lanes, in lane
// order; the last run may be shorter. Each target's sums are a fold over the
// runs in run order of each run's own sum in lane order, starting from zero:
// run boundaries depend on the window's lane sequence alone, never on the
// launch, so every launch shape, every entry and K7 give each target the
// same bits. The partner's (depth, id) maximum does not depend on order.
//
//  * A unit is (window, target group): group g holds the window's targets
//    [32 R g, 32 R (g + 1)), R targets a thread (thread l holds targets
//    32 i + l, i < R), so one staged lane serves R targets. R = 2, or 1 for
//    windows of at most 32 or at least 256 target rows (K8's full columns:
//    more, shorter units) and for K7 (ops/collide.py, launch_shape). Units
//    past a window's target count exit at once; the targets of a large
//    window take units of their own instead of restaging.
//  * A block runs one group of `windows_per_block` consecutive windows;
//    blocks of later groups come first: most windows leave those groups
//    empty, so most of these blocks end at once, and the few long units
//    start early. A team of T warps runs one unit at a time, team j of a
//    block taking its windows j, j + teams, ... T = 1 where a launch has
//    many units: each warp walks its window's runs in turn, four windows a
//    block. T > 1 where it has few (the tail bucket): warp w of the team
//    takes run T k + w of round k, and the team's first warp adds the other
//    warps' run sums, written to shared memory, in run order at the next
//    round. K2m (windows_per_block = W) runs W windows a block, a team each,
//    at once: one warp a team, in the tail as many as the block's 8 warps
//    leave room for.
//  * Staging: each round's T runs go into shared memory with cp.async, one
//    round ahead (double buffer), strip by strip (contiguous rows, no
//    per-lane search): the row's two float4 as the wrapper lays them out,
//    (x y z vx) and (vy vz m r), the id, the sorted row (K2's hit path reads
//    its source flag from it) and, for K7, the source flag. The overlap test
//    reads one 16-byte and one 4-byte shared load a lane (K7: 16 and 8
//    bytes, the id and the flag). The last run is padded to 32 lanes with
//    rows that overlap nothing and pull nothing.
//  * The lane loop runs 32 lanes at a time without branches: each target's
//    hits set bits of a mask; the hits are then taken in lane order (the
//    physics, the partner, the counters). A target that takes no part (no
//    slot, mass <= 0) gets radius NaN, so none of its lanes overlaps.
//
// Decisions (r^2, the overlap test, the depth, the sign of vn) are computed
// without FMA contraction, as the plain PyTorch version computes them, so
// partners and counters agree exactly; the hit path's sums contract, written
// with explicit intrinsics so that every instantiation rounds alike. Each
// thread writes its results straight to body order through order[p]: every
// body holds at most one target slot, so writes never collide.
//
// With gravity (kGrav, the TPU kernel K7): every lane of the window, not only
// the overlapping pairs, also adds the P3M short-range pull of
// csrc/pp_law.cuh (its exact form, pair_weight: rsqrtf, expf and the IEEE
// reciprocal, in the TPU kernels' Horner order; K4 and K5 take the one-MUFU
// form) to the target,
//
//   grav_i = G sum_j w_ij d_ij,  w_ij = m_j [erfc(x)/s + c_a e^(-x^2)] / s^2,
//
// masked to 0 unless both masses are > 0, the ids differ and r^2 > 0 (a
// masked source lane carries mass 0), folded over the runs as the collision
// sums are. Every lane pays an rsqrt, an exp and a reciprocal: K7 is bound by
// the SFU rate on the window's lanes, not by FP32 issue as K2 is; its law is
// not redesigned here, but its masks are one select (pp_law.cuh, keep_pair)
// with the id test folded into the source mass, so no branch keeps the
// unrolled lanes' laws apart. The collision decisions keep their rule on FMA
// contraction, so K7's delta rows and partners are K2's bit for bit.

#include <climits>
#include <cuda_runtime.h>

#include "pp_law.cuh"

namespace {

constexpr int kRun = 128;     // lanes a run: the fold's unit (ops/collide.py RUN)
constexpr int kMaxWarps = 8;  // warps a block (ops/collide.py WARPS)
constexpr int kWinInts = 20;  // ts, tn, 9 x (strip start, kept length)
constexpr float kCorrection = 0.8f;
constexpr float kHeat = 0.2f;
constexpr float kSentinel = -1e30f;
constexpr unsigned kFull = 0xffffffffu;

// A sorted row as the wrapper lays it out: (x y z vx), (vy vz m r).
struct Row {
  float4 a, b;
};

__device__ __forceinline__ float qnan() { return __int_as_float(0x7fc00000); }

// One team's shared memory: the double-buffered staged rounds (rows, ids,
// sorted rows, and K7's source flags), then, for teams of more than one
// warp, the run sums of the team's other warps (double-buffered: written at
// round k, added at round k + 1) and their partners.
struct TeamSmem {
  int ids, qs, oks, part, dj, bytes;
};

__host__ __device__ constexpr TeamSmem team_smem(int team_warps, int targets, bool grav) {
  const int lanes = 2 * team_warps * kRun;
  const int ids = lanes * static_cast<int>(sizeof(Row));
  const int qs = ids + lanes * 4;
  const int oks = qs + lanes * 4;
  const int part = (oks + (grav ? lanes : 0) + 15) & ~15;
  const int sums = grav ? 11 : 8;
  const int dj = part + (team_warps > 1 ? 2 * team_warps * sums * targets * 32 * 4 : 0);
  const int bytes = (dj + (team_warps > 1 ? team_warps * targets * 32 * 8 : 0) + 15) & ~15;
  return TeamSmem{ids, qs, oks, part, dj, bytes};
}

__device__ __forceinline__ void cp_async16(void* dst, const void* src) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(
                   static_cast<unsigned>(__cvta_generic_to_shared(dst))),
               "l"(src)
               : "memory");
}

__device__ __forceinline__ void cp_async4(void* dst, const void* src) {
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4;\n" ::"r"(
                   static_cast<unsigned>(__cvta_generic_to_shared(dst))),
               "l"(src)
               : "memory");
}

__device__ __forceinline__ void cp_async_commit() { asm volatile("cp.async.commit_group;\n" ::: "memory"); }

__device__ __forceinline__ void cp_async_wait_all() { asm volatile("cp.async.wait_all;\n" ::: "memory"); }

// The team's barrier: its warp alone, or named barrier team + 1.
__device__ __forceinline__ void team_sync(int team, int team_warps) {
  if (team_warps == 1) {
    __syncwarp();
  } else {
    asm volatile("bar.sync %0, %1;" ::"r"(team + 1), "r"(team_warps * 32) : "memory");
  }
}

// Stage round r's lanes [r T kRun, ...) of the window (strip s: rows
// [start_s, start_s + len_s) at fused lanes [off_s, off_s + len_s), held by
// lane s of every warp) into buffer r & 1; pad the window's last run to a
// whole number of 32-lane blocks.
template <bool kGrav>
__device__ __forceinline__ void stage(int r, int round_lanes, int total, int s_start, int s_len, int s_off,
                                      int tid, int nthreads, const float4* __restrict__ feats,
                                      const int* __restrict__ order, const unsigned char* __restrict__ src_ok,
                                      Row* rows, int* ids, int* qs, unsigned char* oks) {
  const int base = r * round_lanes;
  const int end = min(total, base + round_lanes);
  const int buf = (r & 1) * round_lanes;
#pragma unroll 1
  for (int s = 0; s < 9; ++s) {
    const int st = __shfl_sync(kFull, s_start, s);
    const int off = __shfl_sync(kFull, s_off, s);
    const int len = __shfl_sync(kFull, s_len, s);
    const int hi = min(end, off + len);
    for (int l = max(base, off) + tid; l < hi; l += nthreads) {
      const int q = st + (l - off);
      const int d = buf + (l - base);
      cp_async16(&rows[d].a, feats + 2 * q);
      cp_async16(&rows[d].b, feats + 2 * q + 1);
      cp_async4(&ids[d], order + q);
      qs[d] = q;
      if (kGrav) oks[d] = src_ok[q];
    }
  }
  if (end == total) {
    const int pad_end = min(base + round_lanes, (total + 31) & ~31);
    for (int l = total + tid; l < pad_end; l += nthreads) {
      const int d = buf + (l - base);
      rows[d].a = make_float4(0.f, 0.f, 0.f, 0.f);
      rows[d].b = make_float4(0.f, 0.f, 0.f, qnan());  // radius NaN: no overlap; mass 0: no pull
      ids[d] = -1;
      qs[d] = 0;
      if (kGrav) oks[d] = 0;
    }
  }
}

// R targets a thread; kGrav adds K7's gravity. See the header for the design.
// The minimum of one block an SM lets ptxas give the R = 1 instantiations the
// registers they need: without it, it held them to 80, and K7 spilled and ran
// 5% slower on the card (PERF.md).
template <int R, bool kGrav>
__global__ void __launch_bounds__(kMaxWarps * 32, 1)
collide_fused_kernel(const float4* __restrict__ feats,          // [n, 2] sorted: (x y z vx), (vy vz m r)
                     const int* __restrict__ order,             // [n] sorted position -> body id
                     const unsigned char* __restrict__ src_ok,  // [n] sorted position may be a source
                     const int* __restrict__ win,               // [n_win, 20]
                     float* __restrict__ out_d,                 // [n, 8] body order
                     int* __restrict__ out_j,                   // [n] body order
                     int n_win, int groups, int windows_per_block, int team_warps, float e, float fric,
                     float* __restrict__ out_g,  // [n, 3] body order (kGrav)
                     nbx_pp::Law law) {
  constexpr int kSums = kGrav ? 11 : 8;
  // lanes a pass of the overlap loop: K2 8, K7 4 (its law is long; 2 or 1
  // lanes ran 6% and 28% slower on the card, PERF.md)
  constexpr int kUnroll = kGrav ? 4 : 8;
  extern __shared__ __align__(16) unsigned char smem[];
  const int tm = team_warps;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int team = warp / tm, tw = warp - team * tm;
  const int teams = (blockDim.x >> 5) / tm;
  const TeamSmem lay = team_smem(tm, R, kGrav);
  unsigned char* base = smem + team * lay.bytes;
  Row* rows = reinterpret_cast<Row*>(base);
  int* ids = reinterpret_cast<int*>(base + lay.ids);
  int* qs = reinterpret_cast<int*>(base + lay.qs);
  unsigned char* oks = base + lay.oks;
  float* part = reinterpret_cast<float*>(base + lay.part);
  float* dj_d = reinterpret_cast<float*>(base + lay.dj);
  int* dj_j = reinterpret_cast<int*>(base + lay.dj) + tm * R * 32;
  const int round_lanes = tm * kRun;
  const int tid = tw * 32 + lane;
  const float one_e = 1.f + e;

  // this block's group g and windows [w0, w0 + nw); the last group's blocks
  // first, so that the few long units of the windows that fill it start
  // early
  const int n_wblocks = (n_win + windows_per_block - 1) / windows_per_block;
  const int w0 = static_cast<int>(blockIdx.x % n_wblocks) * windows_per_block;
  const int t_base = (groups - 1 - static_cast<int>(blockIdx.x / n_wblocks)) * 32 * R;
  const int nw = min(windows_per_block, n_win - w0);
  for (int u = team; u < nw; u += teams) {
    const int* wd = win + static_cast<size_t>(w0 + u) * kWinInts;
    const int ts = wd[0];
    const int tn = wd[1];
    if (t_base >= tn) continue;  // the same for every thread of the team
    team_sync(team, tm);         // the team is done with the previous unit's buffers

    // strip s (lane s < 9): start, kept length, first fused lane
    const int s_start = lane < 9 ? wd[2 + 2 * lane] : 0;
    const int s_len = lane < 9 ? wd[3 + 2 * lane] : 0;
    int incl = s_len;
#pragma unroll
    for (int o = 1; o < 16; o <<= 1) {
      const int v = __shfl_up_sync(kFull, incl, o);
      if (lane >= o) incl += v;
    }
    const int s_off = incl - s_len;
    const int total = __shfl_sync(kFull, incl, 8);

    float xi[R], yi[R], zi[R], ri[R];
    int gi[R], pi[R];
    bool act[R];
#pragma unroll
    for (int i = 0; i < R; ++i) {
      const int t = t_base + i * 32 + lane;
      act[i] = t < tn;
      pi[i] = ts + (act[i] ? t : 0);
      const float4 fa = feats[2 * pi[i]];
      const float4 fb = feats[2 * pi[i] + 1];
      xi[i] = fa.x;
      yi[i] = fa.y;
      zi[i] = fa.z;
      ri[i] = act[i] && fb.z > 0.f ? fb.w : qnan();
      gi[i] = order[pi[i]];
    }
    float tot[R][kSums], s[R][kSums], dmax[R];
    int jsel[R];
#pragma unroll
    for (int i = 0; i < R; ++i) {
      dmax[i] = kSentinel;
      jsel[i] = INT_MAX;
#pragma unroll
      for (int c = 0; c < kSums; ++c) tot[i][c] = 0.f;
    }

    const int n_runs = (total + kRun - 1) / kRun;
    const int n_rounds = (n_runs + tm - 1) / tm;
    // the team's first warp adds round rr's other run sums, in run order
    auto fold_others = [&](int rr) {
      const float* pr = part + (rr & 1) * tm * kSums * R * 32;
      for (int w = 1; w < tm && rr * tm + w < n_runs; ++w) {
#pragma unroll
        for (int c = 0; c < kSums; ++c) {
#pragma unroll
          for (int i = 0; i < R; ++i) tot[i][c] = __fadd_rn(tot[i][c], pr[((w * kSums + c) * R + i) * 32 + lane]);
        }
      }
    };
    if (n_rounds > 0)
      stage<kGrav>(0, round_lanes, total, s_start, s_len, s_off, tid, tm * 32, feats, order, src_ok, rows, ids, qs,
                   oks);
    cp_async_commit();
    for (int r = 0; r < n_rounds; ++r) {
      cp_async_wait_all();
      team_sync(team, tm);  // round r is staged; every warp is done with round r - 1
      if (r + 1 < n_rounds)
        stage<kGrav>(r + 1, round_lanes, total, s_start, s_len, s_off, tid, tm * 32, feats, order, src_ok, rows,
                     ids, qs, oks);
      cp_async_commit();
      if (tm > 1 && tw == 0 && r > 0) fold_others(r - 1);

      const int run = r * tm + tw;
#pragma unroll
      for (int i = 0; i < R; ++i) {
#pragma unroll
        for (int c = 0; c < kSums; ++c) s[i][c] = 0.f;
      }
      if (run < n_runs) {
        const int first = (r & 1) * round_lanes + tw * kRun;
        const Row* rr = rows + first;
        const int* rid = ids + first;
        const int* rq = qs + first;
        const unsigned char* rok = oks + first;
        const int nl = min(kRun, total - run * kRun);
        for (int k0 = 0; k0 < nl; k0 += 32) {
          unsigned hit[R];
#pragma unroll
          for (int i = 0; i < R; ++i) hit[i] = 0u;
          // the miss path: the overlap test of 32 lanes, no branch
#pragma unroll (kUnroll)
          for (int j = 0; j < 32; ++j) {
            const Row* rw = rr + k0 + j;
            const float4 a = rw->a;
            float rj, mj = 0.f;
            int gj = 0;
            if (kGrav) {
              const float2 mr = *reinterpret_cast<const float2*>(&rw->b.z);
              rj = mr.y;
              mj = rok[k0 + j] ? mr.x : 0.f;
              gj = rid[k0 + j];
            } else {
              rj = rw->b.w;
            }
#pragma unroll
            for (int i = 0; i < R; ++i) {
              const float dx = __fsub_rn(a.x, xi[i]);
              const float dy = __fsub_rn(a.y, yi[i]);
              const float dz = __fsub_rn(a.z, zi[i]);
              const float r2 = __fadd_rn(__fadd_rn(__fmul_rn(dx, dx), __fmul_rn(dy, dy)), __fmul_rn(dz, dz));
              const float md = __fadd_rn(ri[i], rj);
              if (r2 < __fmul_rn(md, md)) hit[i] |= 1u << j;
              if (kGrav) {
                const float wg = nbx_pp::pair_weight(r2, gj != gi[i] ? mj : 0.f, law);
                s[i][8] += wg * dx;
                s[i][9] += wg * dy;
                s[i][10] += wg * dz;
              }
            }
          }
          // the hit path: each target's overlapping lanes of the 32, in lane order
#pragma unroll
          for (int i = 0; i < R; ++i) {
            unsigned hm = hit[i];
            while (hm) {
              const int k = k0 + __ffs(hm) - 1;
              hm &= hm - 1;
              const int gj = rid[k];
              if (gj == gi[i]) continue;
              const Row rw = rr[k];
              const bool ok = kGrav ? rok[k] != 0 : src_ok[rq[k]] != 0;
              const float mj = ok ? rw.b.z : 0.f;
              if (!(mj > 0.f)) continue;
              const float dx = __fsub_rn(rw.a.x, xi[i]);
              const float dy = __fsub_rn(rw.a.y, yi[i]);
              const float dz = __fsub_rn(rw.a.z, zi[i]);
              const float r2 = __fadd_rn(__fadd_rn(__fmul_rn(dx, dx), __fmul_rn(dy, dy)), __fmul_rn(dz, dz));
              const float md = __fadd_rn(ri[i], rw.b.w);
              const float inv_dist = rsqrtf(r2 > 0.f ? r2 : 1.f);
              const float dist = __fmul_rn(r2, inv_dist);
              const float depth = __fsub_rn(md, dist);
              if (depth > dmax[i] || (depth == dmax[i] && gj < jsel[i])) {
                dmax[i] = depth;
                jsel[i] = gj;
              }
              const float4 ta = feats[2 * pi[i]];
              const float4 tb = feats[2 * pi[i] + 1];
              const float rvx = __fsub_rn(rw.a.w, ta.w);
              const float rvy = __fsub_rn(rw.b.x, tb.x);
              const float rvz = __fsub_rn(rw.b.y, tb.y);
              const float vn = __fmul_rn(
                  __fadd_rn(__fadd_rn(__fmul_rn(rvx, dx), __fmul_rn(rvy, dy)), __fmul_rn(rvz, dz)), inv_dist);
              if (!(vn < 0.f)) continue;  // not approaching: every term is 0

              const float mi = tb.z;
              const float m_sum = __fadd_rn(mi, mj);
              const float r_ms = __fdiv_rn(1.f, m_sum > 0.f ? m_sum : 1.f);
              const float mu = __fmul_rn(__fmul_rn(mi, mj), r_ms);
              const float tvn = __fmul_rn(vn, mu);
              const float j_imp = __fmul_rn(-one_e, tvn);
              const float ft = __fmul_rn(fric, mu);
              const float c_a = __fmul_rn(__fmaf_rn(ft, vn, j_imp), inv_dist);
              const float c_b = __fmul_rn(__fmul_rn(depth, inv_dist), __fmul_rn(kCorrection, mu));
              s[i][0] = __fadd_rn(s[i][0], __fmaf_rn(c_a, dx, -__fmul_rn(ft, rvx)));
              s[i][1] = __fadd_rn(s[i][1], __fmaf_rn(c_a, dy, -__fmul_rn(ft, rvy)));
              s[i][2] = __fadd_rn(s[i][2], __fmaf_rn(c_a, dz, -__fmul_rn(ft, rvz)));
              s[i][3] = __fmaf_rn(c_b, dx, s[i][3]);
              s[i][4] = __fmaf_rn(c_b, dy, s[i][4]);
              s[i][5] = __fmaf_rn(c_b, dz, s[i][5]);
              s[i][6] = __fmaf_rn(__fmul_rn(0.5f, vn), tvn, s[i][6]);
              s[i][7] = __fadd_rn(s[i][7], 1.f);
            }
          }
        }
      }
      if (tw == 0) {
#pragma unroll
        for (int i = 0; i < R; ++i) {
#pragma unroll
          for (int c = 0; c < kSums; ++c) tot[i][c] = __fadd_rn(tot[i][c], s[i][c]);
        }
      } else if (run < n_runs) {
        float* pw = part + (r & 1) * tm * kSums * R * 32;
#pragma unroll
        for (int c = 0; c < kSums; ++c) {
#pragma unroll
          for (int i = 0; i < R; ++i) pw[((tw * kSums + c) * R + i) * 32 + lane] = s[i][c];
        }
      }
    }
    if (tm > 1) {
      if (tw != 0) {
#pragma unroll
        for (int i = 0; i < R; ++i) {
          dj_d[(tw * R + i) * 32 + lane] = dmax[i];
          dj_j[(tw * R + i) * 32 + lane] = jsel[i];
        }
      }
      team_sync(team, tm);  // the last round's run sums and every warp's partners are in shared memory
      if (tw != 0) continue;
      if (n_rounds > 0) fold_others(n_rounds - 1);
      for (int w = 1; w < tm; ++w) {
#pragma unroll
        for (int i = 0; i < R; ++i) {
          const float d = dj_d[(w * R + i) * 32 + lane];
          const int j = dj_j[(w * R + i) * 32 + lane];
          if (d > dmax[i] || (d == dmax[i] && j < jsel[i])) {
            dmax[i] = d;
            jsel[i] = j;
          }
        }
      }
    }
#pragma unroll
    for (int i = 0; i < R; ++i) {
      if (!act[i]) continue;
      const float mi = feats[2 * pi[i] + 1].z;
      const float sc = mi > 0.f ? __fdiv_rn(1.f, mi) : 0.f;
      float* o = out_d + static_cast<size_t>(gi[i]) * 8;
      o[0] = -tot[i][0] * sc;
      o[1] = -tot[i][1] * sc;
      o[2] = -tot[i][2] * sc;
      o[3] = -tot[i][3] * sc;
      o[4] = -tot[i][4] * sc;
      o[5] = -tot[i][5] * sc;
      o[6] = tot[i][6] * sc * kHeat;
      o[7] = tot[i][7];
      out_j[gi[i]] = dmax[i] > 0.f ? jsel[i] : -1;
      if (kGrav) {
        float* og = out_g + static_cast<size_t>(gi[i]) * 3;
        og[0] = mi > 0.f ? law.g * tot[i][8] : 0.f;
        og[1] = mi > 0.f ? law.g * tot[i][9] : 0.f;
        og[2] = mi > 0.f ? law.g * tot[i][10] : 0.f;
      }
    }
  }
}

struct Shape {
  int n_win, groups, windows_per_block, team_warps, teams;
};

template <int R, bool kGrav>
cudaError_t launch(const void* feats, const void* order, const void* src_ok, const void* win, void* out_d,
                   void* out_j, void* out_g, const Shape& sh, float e, float fric, const nbx_pp::Law& law,
                   cudaStream_t stream) {
  const int smem = sh.teams * team_smem(sh.team_warps, R, kGrav).bytes;
  static int allowed[16] = {};  // the dynamic shared memory this instantiation may take, by device
  int dev = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err != cudaSuccess) return err;
  if (smem > 48 * 1024 && smem > allowed[dev & 15]) {
    err = cudaFuncSetAttribute(collide_fused_kernel<R, kGrav>, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
    if (err != cudaSuccess) return err;
    allowed[dev & 15] = smem;
  }
  const long long blocks =
      static_cast<long long>((sh.n_win + sh.windows_per_block - 1) / sh.windows_per_block) * sh.groups;
  collide_fused_kernel<R, kGrav><<<static_cast<unsigned>(blocks), sh.teams * sh.team_warps * 32, smem, stream>>>(
      static_cast<const float4*>(feats), static_cast<const int*>(order), static_cast<const unsigned char*>(src_ok),
      static_cast<const int*>(win), static_cast<float*>(out_d), static_cast<int*>(out_j), sh.n_win, sh.groups,
      sh.windows_per_block, sh.team_warps, e, fric, static_cast<float*>(out_g), law);
  return cudaGetLastError();
}

template <bool kGrav>
int dispatch(int targets, const void* feats, const void* order, const void* src_ok, const void* win, void* out_d,
             void* out_j, void* out_g, const Shape& sh, float e, float fric, const nbx_pp::Law& law, void* stream) {
  if (sh.n_win <= 0) return static_cast<int>(cudaSuccess);
  const int tm = sh.team_warps;
  if (sh.groups < 1 || sh.windows_per_block < 1 || sh.teams < 1 || !(tm == 1 || tm == 2 || tm == 4 || tm == 8) ||
      sh.teams * tm > kMaxWarps)
    return static_cast<int>(cudaErrorInvalidValue);
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  cudaError_t err;
  // K2: R = 1 or 2 (ops/collide.py, launch_shape); K7: R = 1
  if (targets == 1) {
    err = launch<1, kGrav>(feats, order, src_ok, win, out_d, out_j, out_g, sh, e, fric, law, s);
  } else if constexpr (!kGrav) {
    err = targets == 2 ? launch<2, false>(feats, order, src_ok, win, out_d, out_j, out_g, sh, e, fric, law, s)
                       : cudaErrorInvalidValue;
  } else {
    err = cudaErrorInvalidValue;
  }
  return static_cast<int>(err);
}

}  // namespace

// Plain C entry points, loaded with ctypes. The launch shape
// (ops/collide.py, launch_shape): n_win windows of `groups` units each
// (targets_a_thread targets a thread: 1 or 2, K7 1), windows_per_block
// windows of one group a block, `teams` teams of team_warps warps a block
// (teams * team_warps <= 8; team_warps 1, 2, 4 or 8). Each launches on
// `stream` and returns the launch's cudaError_t (0 on success); neither
// synchronises.
extern "C" int nbx_collide_fused(const void* feats, const void* order, const void* src_ok, const void* win,
                                 void* out_d, void* out_j, int n_win, int groups, int windows_per_block,
                                 int team_warps, int teams, int targets_a_thread, float e, float fric,
                                 void* stream) {
  const nbx_pp::Law none{0.f, 0.f, 0.f, 0.f};
  return dispatch<false>(targets_a_thread, feats, order, src_ok, win, out_d, out_j, nullptr,
                         Shape{n_win, groups, windows_per_block, team_warps, teams}, e, fric, none, stream);
}

// K7: nbx_collide_fused plus the short-range gravity G sum_j w_ij d_ij of
// every target into out_g [n, 3] (body order); the law's constants as the
// JAX package's parameter row holds them: 1/a, 2/(a sqrt(pi)), eps^2.
extern "C" int nbx_collide_fused_grav(const void* feats, const void* order, const void* src_ok, const void* win,
                                      void* out_d, void* out_j, void* out_g, int n_win, int groups,
                                      int windows_per_block, int team_warps, int teams, int targets_a_thread,
                                      float e, float fric, float g, float inv_a, float c_a, float eps2,
                                      void* stream) {
  const nbx_pp::Law law{eps2, inv_a, c_a, g};
  return dispatch<true>(targets_a_thread, feats, order, src_ok, win, out_d, out_j, out_g,
                        Shape{n_win, groups, windows_per_block, team_warps, teams}, e, fric, law, stream);
}
