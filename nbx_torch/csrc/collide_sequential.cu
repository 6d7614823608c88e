// Strict-sequential collision sweep, float32, for NVIDIA Hopper (sm_90a).
//
// Replaces no TPU kernel: `nbx.collisions.resolve_collisions_sequential`
// (nbx/collisions.py:350-578) runs its sweep as one `jax.lax.fori_loop` over
// the flattened c*c pair space under jit, a single device loop a substep.
// Eager PyTorch would spend about a hundred launches and host reads on each
// pair, so this kernel is that loop: one launch a substep, one block.
//
// Contract (ops/sequential.py states it in full; its `sweep_reference` is
// the plain version): pairs (i, j), i < j, in flattened order; a pair is
// live when both bodies are alive and neither was removed earlier in the
// sweep, and overlaps when dist2 < (r_i + r_j)^2 with the radii fixed for
// the sweep. An overlapping pair adds h to its contact timer (and is
// visited); an approaching one (vn < 0) heats both bodies, then merges,
// fractures or bounces in place, so every later pair sees its impulses,
// corrections and heat. Merges and fractures record their payloads into
// fixed buffers (past the caps they count as dropped), mark both bodies
// removed and zero the pair's timer. The timers come back pruned: the
// output matrix, which the wrapper zeroes, receives the timer of every
// overlapping pair that did not fire, so unvisited pairs read 0.
//
// Why a row scan is exact. A live pair that does not overlap changes
// nothing (its timer stays, its heat, correction and impulse are zeros;
// only the sign of an exact zero could differ, which no later comparison or
// product reads). So row i tests its candidates j >= j0 against the current
// positions all at once, one thread a candidate, takes the first hit in j
// order (a ballot and ffs in each warp, the smallest over the warps), lets
// thread 0 apply that pair, and resumes at hit + 1. Only an applied pair
// moves pos[i] or pos[j], and every later test of row i re-reads them.
//
// Arithmetic: every decision (overlap, vn < 0, the merge and fracture
// thresholds) and every update is taken with round-to-nearest intrinsics
// (__fadd_rn, __fmul_rn, __fdiv_rn, __fsqrt_rn), so nothing is contracted
// into an FMA, in the plain version's order of operations (sums of three
// terms left to right); the plain version's torch ops round at the same
// points, so the two agree bitwise on the card.
//
// Layout: the body arrays live in shared memory for the whole sweep, 41
// bytes a body (position and velocity as SoA floats, temperature, mass,
// radius, inverse mass, one live byte), so 5,632 bodies fit in the 227 KB a
// block may take (ops/sequential.py MAX_CAPACITY; the wrapper raises above
// it). The [C, C] timers stay in global memory: only overlapping pairs read
// or write them. Merge and fracture records and the counters have one
// writer, thread 0, so nothing needs atomics.
//
// Bound: the overlap tests, 11 FP32 operations each (3 differences, r^2 as
// 5, r_i + r_j, its square, the compare), on the SMs the launch uses. The
// sweep is sequential by construction, so it runs on one SM: the one-SM
// bound is 132 times the card's. Each row also pays two block barriers a
// chunk of candidates, which the bound does not count.

#include <climits>
#include <cstdint>
#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 512;
constexpr int kWarps = kThreads / 32;

struct Inputs {
  const float* pos;        // [c, 3]
  const float* vel;        // [c, 3]
  const float* temp;       // [c]
  const float* mass;       // [c]
  const float* radius;     // [c]
  const float* inv_m;      // [c]
  const int* mat;          // [c]
  const uint8_t* alive;    // [c] bool
  const float* contact;    // [c, c]
};

struct Outputs {
  float* pos;        // [c, 3]
  float* vel;        // [c, 3]
  float* temp;       // [c]
  uint8_t* removed;  // [c] bool
  float* contact;    // [c, c], zeroed by the wrapper
  int* counts;       // [6] n_bounces, m_cnt, m_drop, f_cnt, f_drop, n_tests
  float* mbuf;       // [mm, 8] pos, vel, mass, temp
  int* mmat;         // [mm]
  float* fbuf;       // [ff, 13] com, bvel, energy, total mass, temp, radius sum, midpoint
  int* fmat;         // [ff]
};

struct Params {
  int c, mm, ff;
  float h, merge_time, merge_q, fracture_q, min_fragment_mass, correction, restitution1, friction;
};

// The body arrays in shared memory.
struct Bodies {
  float *px, *py, *pz, *vx, *vy, *vz, *temp, *mass, *rad, *inv;
  uint8_t* live;
};

__device__ __forceinline__ float dot3(float ax, float ay, float az, float bx, float by, float bz) {
  return __fadd_rn(__fadd_rn(__fmul_rn(ax, bx), __fmul_rn(ay, by)), __fmul_rn(az, bz));
}

// (a_i m_i + a_j m_j) / tot
__device__ __forceinline__ float weighted(float ai, float mi, float aj, float mj, float tot) {
  return __fdiv_rn(__fadd_rn(__fmul_rn(ai, mi), __fmul_rn(aj, mj)), tot);
}

struct Counters {
  int n_bounces = 0, m_cnt = 0, m_drop = 0, f_cnt = 0, f_drop = 0;
};

// Pair (i, j), known to overlap, applied in place by one thread.
__device__ void apply_pair(int i, int j, const Bodies& b, const Inputs& in, const Outputs& out,
                           const Params& p, Counters& n) {
  const float dx = __fsub_rn(b.px[j], b.px[i]);
  const float dy = __fsub_rn(b.py[j], b.py[i]);
  const float dz = __fsub_rn(b.pz[j], b.pz[i]);
  const float dist2 = dot3(dx, dy, dz, dx, dy, dz);
  const float min_dist = __fadd_rn(b.rad[i], b.rad[j]);
  const float c_new = __fadd_rn(in.contact[i * p.c + j], p.h);
  float timer = c_new;

  const float dist = __fsqrt_rn(dist2 > 0.f ? dist2 : 1.f);
  const float nx = __fdiv_rn(dx, dist), ny = __fdiv_rn(dy, dist), nz = __fdiv_rn(dz, dist);
  const float rvx = __fsub_rn(b.vx[j], b.vx[i]);
  const float rvy = __fsub_rn(b.vy[j], b.vy[i]);
  const float rvz = __fsub_rn(b.vz[j], b.vz[i]);
  const float vn = dot3(rvx, rvy, rvz, nx, ny, nz);

  if (vn < 0.f) {  // approaching
    const float mi = b.mass[i], mj = b.mass[j], inv_i = b.inv[i], inv_j = b.inv[j];
    const float inv_sum = __fadd_rn(inv_i, inv_j);
    const float safe_inv_sum = inv_sum > 0.f ? inv_sum : 1.f;
    const float m_sum = __fadd_rn(mi, mj);
    const float tot = m_sum > 0.f ? m_sum : 1.f;
    const float mu = __fdiv_rn(__fmul_rn(mi, mj), tot);
    const float energy = __fmul_rn(__fmul_rn(__fmul_rn(0.5f, mu), vn), vn);
    const float q = __fdiv_rn(energy, tot);

    // heating, before the branch
    b.temp[i] = __fadd_rn(b.temp[i], __fmul_rn(__fmul_rn(energy, inv_i), 0.2f));
    b.temp[j] = __fadd_rn(b.temp[j], __fmul_rn(__fmul_rn(energy, inv_j), 0.2f));

    const bool merge = (c_new > p.merge_time) && (q < p.merge_q);
    const bool fract = !merge && (q > p.fracture_q) && ((mi > p.min_fragment_mass) || (mj > p.min_fragment_mass));
    const int mat = mi > mj ? in.mat[i] : in.mat[j];

    if (merge) {  // payload at fire time, before any correction
      if (n.m_cnt < p.mm) {
        float* r = out.mbuf + 8 * n.m_cnt;
        r[0] = weighted(b.px[i], mi, b.px[j], mj, tot);
        r[1] = weighted(b.py[i], mi, b.py[j], mj, tot);
        r[2] = weighted(b.pz[i], mi, b.pz[j], mj, tot);
        r[3] = weighted(b.vx[i], mi, b.vx[j], mj, tot);
        r[4] = weighted(b.vy[i], mi, b.vy[j], mj, tot);
        r[5] = weighted(b.vz[i], mi, b.vz[j], mj, tot);
        r[6] = m_sum;
        r[7] = weighted(b.temp[i], mi, b.temp[j], mj, tot);
        out.mmat[n.m_cnt] = mat;
        ++n.m_cnt;
      } else {
        ++n.m_drop;
      }
    } else {  // fracture and bounce: position correction
      const float mag = __fmul_rn(__fdiv_rn(__fsub_rn(min_dist, dist), safe_inv_sum), p.correction);
      const float cx = __fmul_rn(mag, nx), cy = __fmul_rn(mag, ny), cz = __fmul_rn(mag, nz);
      b.px[i] = __fadd_rn(b.px[i], __fmul_rn(-cx, inv_i));
      b.py[i] = __fadd_rn(b.py[i], __fmul_rn(-cy, inv_i));
      b.pz[i] = __fadd_rn(b.pz[i], __fmul_rn(-cz, inv_i));
      b.px[j] = __fadd_rn(b.px[j], __fmul_rn(cx, inv_j));
      b.py[j] = __fadd_rn(b.py[j], __fmul_rn(cy, inv_j));
      b.pz[j] = __fadd_rn(b.pz[j], __fmul_rn(cz, inv_j));
    }

    if (fract) {  // payload after the correction
      if (n.f_cnt < p.ff) {
        float* r = out.fbuf + 13 * n.f_cnt;
        r[0] = weighted(b.px[i], mi, b.px[j], mj, tot);
        r[1] = weighted(b.py[i], mi, b.py[j], mj, tot);
        r[2] = weighted(b.pz[i], mi, b.pz[j], mj, tot);
        r[3] = weighted(b.vx[i], mi, b.vx[j], mj, tot);
        r[4] = weighted(b.vy[i], mi, b.vy[j], mj, tot);
        r[5] = weighted(b.vz[i], mi, b.vz[j], mj, tot);
        r[6] = energy;
        r[7] = m_sum;
        r[8] = __fadd_rn(fmaxf(b.temp[i], b.temp[j]), __fmul_rn(__fdiv_rn(energy, tot), 0.1f));
        r[9] = min_dist;
        r[10] = __fmul_rn(0.5f, __fadd_rn(b.px[i], b.px[j]));
        r[11] = __fmul_rn(0.5f, __fadd_rn(b.py[i], b.py[j]));
        r[12] = __fmul_rn(0.5f, __fadd_rn(b.pz[i], b.pz[j]));
        out.fmat[n.f_cnt] = mat;
        ++n.f_cnt;
      } else {
        ++n.f_drop;
      }
    }

    if (merge || fract) {  // both bodies leave the sweep; the pair's timer is deleted
      b.live[i] = 0;
      b.live[j] = 0;
      timer = 0.f;
    } else {  // bounce: normal and friction impulses in place
      const float j_imp = __fdiv_rn(__fmul_rn(-p.restitution1, vn), safe_inv_sum);
      const float tx = __fsub_rn(rvx, __fmul_rn(vn, nx));
      const float ty = __fsub_rn(rvy, __fmul_rn(vn, ny));
      const float tz = __fsub_rn(rvz, __fmul_rn(vn, nz));
      const float t_len = __fsqrt_rn(dot3(tx, ty, tz, tx, ty, tz));
      const float t_div = t_len > 0.f ? t_len : 1.f;
      const float jt = __fdiv_rn(__fmul_rn(-t_len, p.friction), safe_inv_sum);
      const float ix = __fadd_rn(__fmul_rn(j_imp, nx), __fmul_rn(jt, __fdiv_rn(tx, t_div)));
      const float iy = __fadd_rn(__fmul_rn(j_imp, ny), __fmul_rn(jt, __fdiv_rn(ty, t_div)));
      const float iz = __fadd_rn(__fmul_rn(j_imp, nz), __fmul_rn(jt, __fdiv_rn(tz, t_div)));
      b.vx[i] = __fadd_rn(b.vx[i], __fmul_rn(-ix, inv_i));
      b.vy[i] = __fadd_rn(b.vy[i], __fmul_rn(-iy, inv_i));
      b.vz[i] = __fadd_rn(b.vz[i], __fmul_rn(-iz, inv_i));
      b.vx[j] = __fadd_rn(b.vx[j], __fmul_rn(ix, inv_j));
      b.vy[j] = __fadd_rn(b.vy[j], __fmul_rn(iy, inv_j));
      b.vz[j] = __fadd_rn(b.vz[j], __fmul_rn(iz, inv_j));
      ++n.n_bounces;
    }
  }
  out.contact[i * p.c + j] = timer;
  out.contact[j * p.c + i] = timer;
}

__global__ void __launch_bounds__(kThreads, 1)
sweep_kernel(Inputs in, Outputs out, Params p) {
  extern __shared__ float smem[];
  __shared__ int warp_first[2][kWarps];  // double-buffered: one barrier a chunk without a hit
  __shared__ int warp_tests[kWarps];
  const int c = p.c;
  const Bodies b{smem, smem + c, smem + 2 * c, smem + 3 * c, smem + 4 * c, smem + 5 * c,
                 smem + 6 * c, smem + 7 * c, smem + 8 * c, smem + 9 * c,
                 reinterpret_cast<uint8_t*>(smem + 10 * c)};
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  for (int k = tid; k < c; k += kThreads) {
    b.px[k] = in.pos[3 * k + 0];
    b.py[k] = in.pos[3 * k + 1];
    b.pz[k] = in.pos[3 * k + 2];
    b.vx[k] = in.vel[3 * k + 0];
    b.vy[k] = in.vel[3 * k + 1];
    b.vz[k] = in.vel[3 * k + 2];
    b.temp[k] = in.temp[k];
    b.mass[k] = in.mass[k];
    b.rad[k] = in.radius[k];
    b.inv[k] = in.inv_m[k];
    b.live[k] = in.alive[k] ? 1 : 0;
  }
  __syncthreads();

  Counters n;
  int tests = 0;  // this thread's overlap tests up to each row's hits
  int parity = 0;
  for (int i = 0; i < c; ++i) {
    if (!b.live[i]) continue;  // uniform: shared memory after a barrier
    int j0 = i + 1;
    while (j0 < c) {
      const int j = j0 + tid;
      bool tested = false, hit = false;
      if (j < c && b.live[j]) {
        const float dx = __fsub_rn(b.px[j], b.px[i]);
        const float dy = __fsub_rn(b.py[j], b.py[i]);
        const float dz = __fsub_rn(b.pz[j], b.pz[i]);
        const float min_dist = __fadd_rn(b.rad[i], b.rad[j]);
        tested = true;
        hit = dot3(dx, dy, dz, dx, dy, dz) < __fmul_rn(min_dist, min_dist);
      }
      const unsigned ballot = __ballot_sync(0xffffffffu, hit);
      if (lane == 0) warp_first[parity][warp] = ballot ? j0 + 32 * warp + __ffs(ballot) - 1 : INT_MAX;
      __syncthreads();
      int first = INT_MAX;
#pragma unroll
      for (int w = 0; w < kWarps; ++w) first = min(first, warp_first[parity][w]);
      parity ^= 1;
      tests += (tested && j <= first) ? 1 : 0;
      if (first == INT_MAX) {
        j0 += kThreads;
        continue;
      }
      if (tid == 0) apply_pair(i, first, b, in, out, p, n);
      __syncthreads();
      if (!b.live[i]) break;  // row i fired: its later pairs are not live
      j0 = first + 1;
    }
  }
  __syncthreads();

  for (int k = tid; k < c; k += kThreads) {
    out.pos[3 * k + 0] = b.px[k];
    out.pos[3 * k + 1] = b.py[k];
    out.pos[3 * k + 2] = b.pz[k];
    out.vel[3 * k + 0] = b.vx[k];
    out.vel[3 * k + 1] = b.vy[k];
    out.vel[3 * k + 2] = b.vz[k];
    out.temp[k] = b.temp[k];
    out.removed[k] = (in.alive[k] && !b.live[k]) ? 1 : 0;
  }
  tests = __reduce_add_sync(0xffffffffu, tests);
  if (lane == 0) warp_tests[warp] = tests;
  __syncthreads();
  if (tid == 0) {
    int total = 0;
    for (int w = 0; w < kWarps; ++w) total += warp_tests[w];
    out.counts[0] = n.n_bounces;
    out.counts[1] = n.m_cnt;
    out.counts[2] = n.m_drop;
    out.counts[3] = n.f_cnt;
    out.counts[4] = n.f_drop;
    out.counts[5] = total;
  }
}

}  // namespace

// One sweep on `stream`: the body inputs, the timers in, the outputs (timers
// out zeroed, buffers zeroed by the wrapper), the sizes and the constants.
extern "C" int nbx_collide_sequential(const void* pos, const void* vel, const void* temp, const void* mass,
                                      const void* radius, const void* inv_m, const void* mat, const void* alive,
                                      const void* contact, void* pos_out, void* vel_out, void* temp_out,
                                      void* removed_out, void* contact_out, void* counts, void* mbuf, void* mmat,
                                      void* fbuf, void* fmat, int c, int mm, int ff, float h, float merge_time,
                                      float merge_q, float fracture_q, float min_fragment_mass, float correction,
                                      float restitution1, float friction, void* stream) {
  const Inputs in{static_cast<const float*>(pos),    static_cast<const float*>(vel),
                  static_cast<const float*>(temp),   static_cast<const float*>(mass),
                  static_cast<const float*>(radius), static_cast<const float*>(inv_m),
                  static_cast<const int*>(mat),      static_cast<const uint8_t*>(alive),
                  static_cast<const float*>(contact)};
  const Outputs out{static_cast<float*>(pos_out),     static_cast<float*>(vel_out),
                    static_cast<float*>(temp_out),    static_cast<uint8_t*>(removed_out),
                    static_cast<float*>(contact_out), static_cast<int*>(counts),
                    static_cast<float*>(mbuf),        static_cast<int*>(mmat),
                    static_cast<float*>(fbuf),        static_cast<int*>(fmat)};
  const Params p{c, mm, ff, h, merge_time, merge_q, fracture_q, min_fragment_mass, correction, restitution1,
                 friction};
  const size_t smem = static_cast<size_t>(c) * (10 * sizeof(float) + 1);
  cudaError_t err = cudaFuncSetAttribute(sweep_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                                         static_cast<int>(smem));
  if (err != cudaSuccess) return static_cast<int>(err);
  sweep_kernel<<<1, kThreads, smem, static_cast<cudaStream_t>(stream)>>>(in, out, p);
  return static_cast<int>(cudaGetLastError());
}
