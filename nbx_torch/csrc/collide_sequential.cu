// Strict-sequential collision sweep, float32, for NVIDIA Hopper (sm_90a).
//
// Replaces no TPU kernel: `nbx.collisions.resolve_collisions_sequential`
// (nbx/collisions.py:350-578) runs its sweep as one `jax.lax.fori_loop` over
// the flattened c*c pair space under jit, a single device loop a substep.
// Eager PyTorch would spend about a hundred launches and host reads on each
// pair, so this is that loop: two launches a substep, a card-wide pre-pass
// and a one-block walk.
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
// output matrix, which the pre-pass zeroes, receives the timer of every
// overlapping pair that did not fire, so unvisited pairs read 0.
//
// Why a row walk is exact. A live pair that does not overlap changes
// nothing (its timer stays, its heat, correction and impulse are zeros;
// only the sign of an exact zero could differ, which no later comparison or
// product reads). So row i may skip any candidate that cannot overlap, take
// the first hit in j order among the rest, apply it and resume at hit + 1:
// only an applied pair moves pos[i] or pos[j], and every later test of row i
// re-reads them.
//
// Which candidates cannot overlap. With u = 2^-24, each round-to-nearest
// operation is exact within a factor 1 +- u. The overlap test computes
// dist2 = (dx dx + dy dy) + dz dz from rounded differences and compares it
// with md md, md = r_i + r_j rounded: dist2 >= D^2 (1 - u)^5 and md md <=
// (r_i + r_j)^2 (1 + u)^3, D the real distance, so a hit means D < (r_i +
// r_j)(1 + 4.1 u). The pre-pass takes the same test at the start positions
// with md scaled by kNearScale = 2 (exact), a margin of r_i + r_j, and marks
// the pair near where it passes; a pair that is not near has, the same way,
// a start distance D0 >= 2 (r_i + r_j)(1 - 5.1 u). Positions move only by
// apply_warp's corrections. After each move of body k the walk adds the
// move's |dx| + |dy| + |dz| (differences and sums rounded to nearest) to
// disp[k]; the real move is at most that times 1 + 3.1 u, and a body moves
// at most C - 1 times a sweep (once a row as a partner, once a partner in
// its own row), so its real displacement since the start is at most disp[k]
// (1 + (C + 3) u) < 1.00035 disp[k] for C <= 5,632. Body k escapes once
// disp[k] > kEscape r_k (rounded), kEscape = 15/16: its share of the margin
// less 1/16 of it. While neither body of a pair has escaped, the triangle
// inequality gives D >= D0 - 1.00035 (1 + u) 0.9375 (r_i + r_j) > 1.06 (r_i
// + r_j): no hit. The slack, 0.06 (r_i + r_j), is five orders of magnitude
// above the rounding terms (the argument holds while the radii's squares are
// normal floats: r_i + r_j between 1.1e-19 and 9e18). So row i tests, of its
// live candidates j >= j0, those near i or escaped, and every live one once
// i itself has escaped. ops/sequential.py `_near_walk_reference` walks the
// same rule in torch ops, and the tests hold it bitwise to the plain sweep.
//
// Arithmetic: every decision (overlap, vn < 0, the merge and fracture
// thresholds) and every update is taken with round-to-nearest intrinsics
// (__fadd_rn, __fmul_rn, __fdiv_rn, __fsqrt_rn), so nothing is contracted
// into an FMA, in the plain version's order of operations (sums of three
// terms left to right); the plain version's torch ops round at the same
// points, so the two agree bitwise on the card.
//
// Layout. The pre-pass (near_kernel, one warp a row, many blocks) zeroes
// the timers out and the record buffers with streaming stores, then writes
// the near bitmask [C, ceil(C/32)] words (3.96 MB at 5,632 bodies: it stays
// in L2) and each row's span of nonzero words, so the wrapper fills
// nothing. The walk (walk_kernel, one block of 512 threads) keeps the bodies
// in shared memory for the whole sweep: position, velocity, temperature,
// radius, the displacement bound and the row's span of near words, 40 bytes
// a body, beside two bitmasks (live, escaped); 5,632 bodies take 226,688 of
// the 232,448 bytes a block may use (ops/sequential.py MAX_CAPACITY; the
// wrapper raises above it). A hit reads the masses and inverse masses from
// global memory (ld.global.nc): they are read once a hit, under its first
// square root and division.
// Warp 0 walks the rows alone. The next row with work (live, and near
// words, an escaped body above it, or escaped itself) is found 32 rows a
// step; a live row without work tests every live body above it and changes
// nothing, so it is only counted. In a row, lane l takes word w0 + l of the
// row's span, its candidates (near | escaped) & live, two tests a step in j
// order, and a ballot and ffs give the row's first hit; that lane loads the
// pair's timer, and the warp applies the pair (apply_warp). A row costs no
// barrier. Only an escaped row brings the other 15 warps in, through named
// barrier 1: 512 candidates a round as the first form scanned every row.
// Every read of shared memory in the walk's hot paths is unconditional (a
// clamped index, the masks by select): a condition around a read compiles
// to a branch that waits on it. The overlap tests are counted, as the plain
// version counts them, from the live bits: a row's live candidates up to
// the hit that removed it, or every live body above it. Merge and fracture
// records, the counters and the bookkeeping have one writer, lane 0 of warp
// 0, so nothing needs atomics.
//
// Bound: the overlap tests, 11 FP32 operations each, and the pre-pass's
// C^2/2, on the SMs the launches use; the timers written once. The walk is
// sequential by construction, on one SM: its bound there is 132 times the
// card's. A hit's dependent IEEE divisions and square roots (two square
// roots and three division steps on the warp) and each pass's chain of
// shared-memory reads are latency the bound does not count.

#include <climits>
#include <cstdint>
#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 512;
constexpr int kWarps = kThreads / 32;
constexpr int kNearWarps = 8;        // the pre-pass's warps a block, a row each
constexpr float kNearScale = 2.0f;   // ops/sequential.py NEAR_SCALE
constexpr float kEscape = 0.9375f;   // ops/sequential.py ESCAPE
constexpr unsigned kFull = 0xffffffffu;

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
  float* contact;    // [c, c], zeroed by the pre-pass
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

// The body arrays in shared memory; span[k] = lo | hi << 16, row k's near
// words [lo, hi); live and esc one bit a body.
struct Bodies {
  float *px, *py, *pz, *vx, *vy, *vz, *temp, *rad, *disp;
  unsigned *span, *live, *esc;
  int* esc_hi;  // the highest escaped body, or -1

  __device__ bool is_live(int k) const { return (live[k >> 5] >> (k & 31)) & 1u; }
  __device__ bool escaped(int k) const { return (esc[k >> 5] >> (k & 31)) & 1u; }
};

__device__ __forceinline__ float dot3(float ax, float ay, float az, float bx, float by, float bz) {
  return __fadd_rn(__fadd_rn(__fmul_rn(ax, bx), __fmul_rn(ay, by)), __fmul_rn(az, bz));
}

// The overlap test of bodies at (xi, yi, zi) and j, as the plain version takes it.
__device__ __forceinline__ bool overlaps(float xi, float yi, float zi, float ri, int j, const Bodies& b) {
  const float dx = __fsub_rn(b.px[j], xi);
  const float dy = __fsub_rn(b.py[j], yi);
  const float dz = __fsub_rn(b.pz[j], zi);
  const float md = __fadd_rn(ri, b.rad[j]);
  return dot3(dx, dy, dz, dx, dy, dz) < __fmul_rn(md, md);
}

// (a_i m_i + a_j m_j) / tot
__device__ __forceinline__ float weighted(float ai, float mi, float aj, float mj, float tot) {
  return __fdiv_rn(__fadd_rn(__fmul_rn(ai, mi), __fmul_rn(aj, mj)), tot);
}

// In shared memory: the thread that applies a pair is the lane that found
// it, so the counters and record slots live where every lane sees them.
struct Counters {
  int n_bounces, m_cnt, m_drop, f_cnt, f_drop;
};

// dst = *src where p: a predicated load that does not wait for its data
// (a select on a loaded value would), so it runs under the hit's first
// divisions.
__device__ __forceinline__ void load_if(bool p, const float* src, float& dst) {
  asm volatile("{\n\t.reg .pred q;\n\tsetp.ne.b32 q, %2, 0;\n\t@q ld.global.nc.f32 %0, [%1];\n\t}"
               : "+f"(dst)
               : "l"(src), "r"(static_cast<int>(p)));
}

// The pair (i, j)'s timer in, where p: what a hit reads from global memory,
// loaded where the hit is found, so that the load runs under its first
// divisions.
__device__ __forceinline__ void load_timer(bool p, int i, int j, const Inputs& in, int c, float& timer) {
  load_if(p, in.contact + static_cast<size_t>(i) * c + j, timer);
}

// Body k moved from (ox, oy, oz): add the move's L1 length to its
// displacement bound, and mark it escaped past kEscape r_k.
__device__ void moved(int k, float ox, float oy, float oz, const Bodies& b) {
  const float step = __fadd_rn(__fadd_rn(fabsf(__fsub_rn(b.px[k], ox)), fabsf(__fsub_rn(b.py[k], oy))),
                               fabsf(__fsub_rn(b.pz[k], oz)));
  b.disp[k] = __fadd_rn(b.disp[k], step);
  if (b.disp[k] > __fmul_rn(b.rad[k], kEscape)) {
    b.esc[k >> 5] |= 1u << (k & 31);
    *b.esc_hi = max(*b.esc_hi, k);
  }
}

// Pair (i, j), known to overlap, applied in place by a whole warp: its
// IEEE divisions and square roots, a chain on one thread (each division a
// branch region that the next cannot overlap), run side by side on the
// lanes, one division a lane with that lane's operands: the normal's three
// components, then mu, the correction's quotient, the normal and friction
// impulses and t / |t|'s three components; shuffles share them, so each
// value is the plain version's, the same operation on the same operands.
// Lane 0 alone stores, so every write has one writer. The pair's timer was
// loaded by lane `src` (load_timer) and is read at the merge test.
__device__ void apply_warp(int i, int j, int src, float timer_src, const Bodies& b, const Inputs& in,
                           const Outputs& out, const Params& p, Counters& n) {
  const int lane = threadIdx.x & 31;
  const float mi = __ldg(in.mass + i), inv_i = __ldg(in.inv_m + i), mj = __ldg(in.mass + j),
              inv_j = __ldg(in.inv_m + j);
  const float pix = b.px[i], piy = b.py[i], piz = b.pz[i], pjx = b.px[j], pjy = b.py[j], pjz = b.pz[j];
  const float vix = b.vx[i], viy = b.vy[i], viz = b.vz[i], vjx = b.vx[j], vjy = b.vy[j], vjz = b.vz[j];
  const float dx = __fsub_rn(pjx, pix);
  const float dy = __fsub_rn(pjy, piy);
  const float dz = __fsub_rn(pjz, piz);
  const float dist2 = dot3(dx, dy, dz, dx, dy, dz);
  const float min_dist = __fadd_rn(b.rad[i], b.rad[j]);

  const float dist = __fsqrt_rn(dist2 > 0.f ? dist2 : 1.f);
  const float n_lane = __fdiv_rn(lane == 0 ? dx : lane == 1 ? dy : dz, dist);
  const float nx = __shfl_sync(kFull, n_lane, 0), ny = __shfl_sync(kFull, n_lane, 1),
              nz = __shfl_sync(kFull, n_lane, 2);
  const float rvx = __fsub_rn(vjx, vix);
  const float rvy = __fsub_rn(vjy, viy);
  const float rvz = __fsub_rn(vjz, viz);
  const float vn = dot3(rvx, rvy, rvz, nx, ny, nz);

  const float inv_sum = __fadd_rn(inv_i, inv_j);
  const float safe_inv_sum = inv_sum > 0.f ? inv_sum : 1.f;
  const float m_sum = __fadd_rn(mi, mj);
  const float tot = m_sum > 0.f ? m_sum : 1.f;
  const float tx = __fsub_rn(rvx, __fmul_rn(vn, nx));
  const float ty = __fsub_rn(rvy, __fmul_rn(vn, ny));
  const float tz = __fsub_rn(rvz, __fmul_rn(vn, nz));
  const float t_len = __fsqrt_rn(dot3(tx, ty, tz, tx, ty, tz));
  const float t_div = t_len > 0.f ? t_len : 1.f;
  // one division a lane: mu, the correction's and the impulses' quotients, t / |t|
  float num = 0.f, den = 1.f;
  num = lane == 0 ? __fmul_rn(mi, mj) : num;
  den = lane == 0 ? tot : den;
  num = lane == 1 ? __fsub_rn(min_dist, dist) : num;
  num = lane == 2 ? __fmul_rn(-p.restitution1, vn) : num;
  num = lane == 3 ? __fmul_rn(-t_len, p.friction) : num;
  den = lane >= 1 && lane <= 3 ? safe_inv_sum : den;
  num = lane == 4 ? tx : lane == 5 ? ty : lane == 6 ? tz : num;
  den = lane >= 4 && lane <= 6 ? t_div : den;
  const float quo = __fdiv_rn(num, den);
  const float mu = __shfl_sync(kFull, quo, 0), mag_q = __shfl_sync(kFull, quo, 1),
              j_imp = __shfl_sync(kFull, quo, 2), jt = __shfl_sync(kFull, quo, 3);
  const float ux = __shfl_sync(kFull, quo, 4), uy = __shfl_sync(kFull, quo, 5), uz = __shfl_sync(kFull, quo, 6);
  const float energy = __fmul_rn(__fmul_rn(__fmul_rn(0.5f, mu), vn), vn);
  const float q = __fdiv_rn(energy, tot);
  const float c_new = __fadd_rn(__shfl_sync(kFull, timer_src, src), p.h);
  if (lane != 0) return;

  float timer = c_new;
  if (vn < 0.f) {  // approaching
    // heating, before the branch
    b.temp[i] = __fadd_rn(b.temp[i], __fmul_rn(__fmul_rn(energy, inv_i), 0.2f));
    b.temp[j] = __fadd_rn(b.temp[j], __fmul_rn(__fmul_rn(energy, inv_j), 0.2f));

    const bool merge = (q < p.merge_q) && (c_new > p.merge_time);
    const bool fract = !merge && (q > p.fracture_q) && ((mi > p.min_fragment_mass) || (mj > p.min_fragment_mass));
    // the position correction (fracture and bounce)
    const float mag = __fmul_rn(mag_q, p.correction);
    const float cx = __fmul_rn(mag, nx), cy = __fmul_rn(mag, ny), cz = __fmul_rn(mag, nz);
    const float qix = __fadd_rn(pix, __fmul_rn(-cx, inv_i));
    const float qiy = __fadd_rn(piy, __fmul_rn(-cy, inv_i));
    const float qiz = __fadd_rn(piz, __fmul_rn(-cz, inv_i));
    const float qjx = __fadd_rn(pjx, __fmul_rn(cx, inv_j));
    const float qjy = __fadd_rn(pjy, __fmul_rn(cy, inv_j));
    const float qjz = __fadd_rn(pjz, __fmul_rn(cz, inv_j));

    if (merge) {  // payload at fire time, before any correction
      if (n.m_cnt < p.mm) {
        float* r = out.mbuf + 8 * n.m_cnt;
        r[0] = weighted(pix, mi, pjx, mj, tot);
        r[1] = weighted(piy, mi, pjy, mj, tot);
        r[2] = weighted(piz, mi, pjz, mj, tot);
        r[3] = weighted(vix, mi, vjx, mj, tot);
        r[4] = weighted(viy, mi, vjy, mj, tot);
        r[5] = weighted(viz, mi, vjz, mj, tot);
        r[6] = m_sum;
        r[7] = weighted(b.temp[i], mi, b.temp[j], mj, tot);
        out.mmat[n.m_cnt] = mi > mj ? in.mat[i] : in.mat[j];
        ++n.m_cnt;
      } else {
        ++n.m_drop;
      }
    } else {  // fracture and bounce: position correction
      b.px[i] = qix;
      b.py[i] = qiy;
      b.pz[i] = qiz;
      b.px[j] = qjx;
      b.py[j] = qjy;
      b.pz[j] = qjz;
      moved(i, pix, piy, piz, b);
      moved(j, pjx, pjy, pjz, b);
    }

    if (fract) {  // payload after the correction
      if (n.f_cnt < p.ff) {
        float* r = out.fbuf + 13 * n.f_cnt;
        r[0] = weighted(qix, mi, qjx, mj, tot);
        r[1] = weighted(qiy, mi, qjy, mj, tot);
        r[2] = weighted(qiz, mi, qjz, mj, tot);
        r[3] = weighted(vix, mi, vjx, mj, tot);
        r[4] = weighted(viy, mi, vjy, mj, tot);
        r[5] = weighted(viz, mi, vjz, mj, tot);
        r[6] = energy;
        r[7] = m_sum;
        r[8] = __fadd_rn(fmaxf(b.temp[i], b.temp[j]), __fmul_rn(__fdiv_rn(energy, tot), 0.1f));
        r[9] = min_dist;
        r[10] = __fmul_rn(0.5f, __fadd_rn(qix, qjx));
        r[11] = __fmul_rn(0.5f, __fadd_rn(qiy, qjy));
        r[12] = __fmul_rn(0.5f, __fadd_rn(qiz, qjz));
        out.fmat[n.f_cnt] = mi > mj ? in.mat[i] : in.mat[j];
        ++n.f_cnt;
      } else {
        ++n.f_drop;
      }
    }

    if (merge || fract) {  // both bodies leave the sweep; the pair's timer is deleted
      b.live[i >> 5] &= ~(1u << (i & 31));
      b.live[j >> 5] &= ~(1u << (j & 31));
      timer = 0.f;
    } else {  // bounce: normal and friction impulses in place
      const float ix = __fadd_rn(__fmul_rn(j_imp, nx), __fmul_rn(jt, ux));
      const float iy = __fadd_rn(__fmul_rn(j_imp, ny), __fmul_rn(jt, uy));
      const float iz = __fadd_rn(__fmul_rn(j_imp, nz), __fmul_rn(jt, uz));
      b.vx[i] = __fadd_rn(vix, __fmul_rn(-ix, inv_i));
      b.vy[i] = __fadd_rn(viy, __fmul_rn(-iy, inv_i));
      b.vz[i] = __fadd_rn(viz, __fmul_rn(-iz, inv_i));
      b.vx[j] = __fadd_rn(vjx, __fmul_rn(ix, inv_j));
      b.vy[j] = __fadd_rn(vjy, __fmul_rn(iy, inv_j));
      b.vz[j] = __fadd_rn(vjz, __fmul_rn(iz, inv_j));
      ++n.n_bounces;
    }
  }
  out.contact[static_cast<size_t>(i) * p.c + j] = timer;
  out.contact[static_cast<size_t>(j) * p.c + i] = timer;
}

// The pre-pass: each warp a row i, the near bits of j > i at the start
// positions and the row's span of nonzero words; every thread zeroes a share
// of the timers out and the record buffers.
__global__ void __launch_bounds__(kNearWarps * 32)
near_kernel(const float* __restrict__ pos, const float* __restrict__ radius, int c, unsigned* __restrict__ near,
            unsigned* __restrict__ span, Outputs out, int mm, int ff) {
  const long long tid = static_cast<long long>(blockIdx.x) * blockDim.x + threadIdx.x;
  const long long nthreads = static_cast<long long>(gridDim.x) * blockDim.x;
  const long long cc = static_cast<long long>(c) * c;
  // the zeros as streaming stores (evict first), so that the [C, C] timers do
  // not push the near words and the bodies out of L2 before the walk
  float4* c4 = reinterpret_cast<float4*>(out.contact);  // 256-byte aligned (the caching allocator)
  for (long long k = tid; k < cc / 4; k += nthreads) __stcs(c4 + k, make_float4(0.f, 0.f, 0.f, 0.f));
  for (long long k = cc / 4 * 4 + tid; k < cc; k += nthreads) __stcs(out.contact + k, 0.f);
  for (long long k = tid; k < 8LL * mm; k += nthreads) out.mbuf[k] = 0.f;
  for (long long k = tid; k < 13LL * ff; k += nthreads) out.fbuf[k] = 0.f;
  for (long long k = tid; k < mm; k += nthreads) out.mmat[k] = 0;
  for (long long k = tid; k < ff; k += nthreads) out.fmat[k] = 0;

  const int lane = threadIdx.x & 31;
  const int nw = (c + 31) >> 5;
  for (long long row = tid >> 5; row < c; row += nthreads >> 5) {
    const int i = static_cast<int>(row);
    const float xi = pos[3 * i], yi = pos[3 * i + 1], zi = pos[3 * i + 2], ri = radius[i];
    const int w_first = (i + 1) >> 5;
    int lo = INT_MAX, hi = 0;
    unsigned mine = 0;
    for (int w = w_first; w < nw; ++w) {
      const int j = (w << 5) + lane;
      bool hit = false;
      if (j > i && j < c) {
        const float dx = __fsub_rn(pos[3 * j], xi);
        const float dy = __fsub_rn(pos[3 * j + 1], yi);
        const float dz = __fsub_rn(pos[3 * j + 2], zi);
        const float s = __fmul_rn(__fadd_rn(ri, radius[j]), kNearScale);
        hit = dot3(dx, dy, dz, dx, dy, dz) < __fmul_rn(s, s);
      }
      const unsigned word = __ballot_sync(kFull, hit);
      if (word) {
        lo = min(lo, w);
        hi = w + 1;
      }
      if ((w & 31) == lane) mine = word;
      if ((w & 31) == 31 || w == nw - 1) {  // this lane's word of the 32 just tested
        const int k = (w & ~31) + lane;
        if (k >= w_first && k <= w) near[static_cast<size_t>(i) * nw + k] = mine;
      }
    }
    if (lane == 0) span[i] = lo == INT_MAX ? 0u : static_cast<unsigned>(lo) | (static_cast<unsigned>(hi) << 16);
  }
}

__device__ __forceinline__ void bar1() { asm volatile("bar.sync 1, %0;" ::"n"(kThreads) : "memory"); }

// Row i's full scan from j0 by the whole block, 512 candidates a round, as
// the first form scanned every row. Returns the partner of the hit that
// removed i, or -1.
__device__ int full_scan(int i, int j0, const Bodies& b, const Inputs& in, const Outputs& out, const Params& p,
                         Counters& n, int (*warp_first)[kWarps], int& parity) {
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  while (j0 < p.c) {
    const int j = j0 + tid;
    const bool hit = j < p.c && b.is_live(j) && overlaps(b.px[i], b.py[i], b.pz[i], b.rad[i], j, b);
    const unsigned ballot = __ballot_sync(kFull, hit);
    if (lane == 0) warp_first[parity][warp] = ballot ? j0 + 32 * warp + __ffs(ballot) - 1 : INT_MAX;
    bar1();
    int first = INT_MAX;
#pragma unroll
    for (int w = 0; w < kWarps; ++w) first = min(first, warp_first[parity][w]);
    parity ^= 1;  // double-buffered: one barrier a round without a hit
    if (first == INT_MAX) {
      j0 += kThreads;
      continue;
    }
    if (warp == 0) {
      float timer = 0.f;
      load_timer(lane == 0, i, first, in, p.c, timer);
      apply_warp(i, first, 0, timer, b, in, out, p, n);
    }
    bar1();
    if (!b.is_live(i)) return first;  // row i fired: its later pairs are not live
    j0 = first + 1;
  }
  return -1;
}

// Row i's walk by warp 0 (i has not escaped): its live candidates j >= j0
// near i or escaped, 32 words of the row a pass, lane l word w0 + l, in j
// order, the passes from the row's first near word lo (from j0's where an
// escaped body lies above j0); `nb` keeps the near words of the pass from
// word `cached`, which a later pass of the row reuses. The lane that finds
// the row's first hit loads the pair's timer, and the warp applies it.
// Returns the partner of the hit that removed i (j0 = c), -1 with j0 = c
// when the row is done, or -1 with j0 < c when i escaped at a hit: the rest
// of the row is a full scan from j0.
__device__ int walk_row(int i, int& j0, const Bodies& b, const unsigned* __restrict__ near_row, const Inputs& in,
                        const Outputs& out, const Params& p, Counters& n) {
  const int lane = threadIdx.x & 31, nw = (p.c + 31) >> 5;
  int cached = -1;
  unsigned nb = 0;
  const unsigned sp = b.span[i];
  const int lo = static_cast<int>(sp & 0xffffu), hi = static_cast<int>(sp >> 16);
  for (;;) {
    const int eh = *b.esc_hi;
    const int w_first = j0 >> 5;
    const int w_end = max(hi, eh >= j0 ? (eh >> 5) + 1 : 0);  // words that can hold a candidate
    const int w_from = eh >= j0 ? w_first : max(w_first, lo);
    const int origin = eh >= j0 ? w_first & ~31 : lo;
    const float xi = b.px[i], yi = b.py[i], zi = b.pz[i], ri = b.rad[i];
    int first = INT_MAX, winner = 0;
    float timer = 0.f;
    for (int w0 = origin + ((w_from - origin) & ~31); w0 < w_end; w0 += 32) {
      const int w = w0 + lane;
      if (w0 != cached) {
        nb = (w >= lo) & (w < hi) ? near_row[w] : 0u;
        cached = w0;
      }
      // every read unconditional (a clamped word) and the masks by select: a
      // condition around a shared read compiles to a branch that waits on it
      const int wc = min(w, nw - 1);
      unsigned cand = (nb | b.esc[wc]) & b.live[wc];
      cand &= (w >= w_first) & (w < w_end) ? (w == w_first ? kFull << (j0 & 31) : kFull) : 0u;
      int mine = INT_MAX;
      while (cand) {  // two candidates a step, their tests independent
        const int j1 = (w << 5) + __ffs(cand) - 1;
        cand &= cand - 1;
        const int j2 = cand ? (w << 5) + __ffs(cand) - 1 : j1;
        cand &= cand - 1;
        const bool h1 = overlaps(xi, yi, zi, ri, j1, b), h2 = overlaps(xi, yi, zi, ri, j2, b);
        if (h1 || h2) {
          mine = h1 ? j1 : j2;
          break;
        }
      }
      load_timer(mine != INT_MAX, i, mine, in, p.c, timer);
      const unsigned any = __ballot_sync(kFull, mine != INT_MAX);
      if (any) {
        winner = __ffs(any) - 1;
        first = __shfl_sync(kFull, mine, winner);
        break;
      }
    }
    if (first == INT_MAX) {
      j0 = p.c;
      return -1;
    }
    apply_warp(i, first, winner, timer, b, in, out, p, n);
    __syncwarp();
    if (!b.is_live(i)) {
      j0 = p.c;
      return first;
    }
    j0 = first + 1;
    if (b.escaped(i)) return -1;
  }
}

// Live bodies in (i, j], by warp 0.
__device__ int live_between(int i, int j, const Bodies& b) {
  const int lane = threadIdx.x & 31;
  int count = 0;
  for (int w = ((i + 1) >> 5) + lane; w <= (j >> 5); w += 32) {
    unsigned m = b.live[w];
    if (w == ((i + 1) >> 5)) m &= kFull << ((i + 1) & 31);
    if (w == (j >> 5) && (j & 31) != 31) m &= (2u << (j & 31)) - 1u;
    count += __popc(m);
  }
  return __reduce_add_sync(kFull, count);
}

__global__ void __launch_bounds__(kThreads, 1)
walk_kernel(Inputs in, Outputs out, Params p, const unsigned* __restrict__ near,
            const unsigned* __restrict__ span) {
  extern __shared__ float smem[];
  __shared__ int warp_first[2][kWarps];
  __shared__ int cmd[2];  // an escaped row's full scan: row (< 0: the walk is over), j0
  __shared__ int esc_hi;
  __shared__ Counters n;
  const int c = p.c, nw = (c + 31) >> 5;
  const Bodies b{smem, smem + c, smem + 2 * c, smem + 3 * c, smem + 4 * c, smem + 5 * c,
                 smem + 6 * c, smem + 7 * c, smem + 8 * c,
                 reinterpret_cast<unsigned*>(smem + 9 * c),
                 reinterpret_cast<unsigned*>(smem + 10 * c),
                 reinterpret_cast<unsigned*>(smem + 10 * c) + nw, &esc_hi};
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  for (int k = tid; k < c; k += kThreads) {
    b.px[k] = in.pos[3 * k + 0];
    b.py[k] = in.pos[3 * k + 1];
    b.pz[k] = in.pos[3 * k + 2];
    b.vx[k] = in.vel[3 * k + 0];
    b.vy[k] = in.vel[3 * k + 1];
    b.vz[k] = in.vel[3 * k + 2];
    b.temp[k] = in.temp[k];
    b.rad[k] = in.radius[k];
    b.disp[k] = 0.f;
    b.span[k] = span[k];
  }
  for (int w = warp; w < nw; w += kWarps) {
    const int k = (w << 5) + lane;
    const unsigned m = __ballot_sync(kFull, k < c && in.alive[k]);
    if (lane == 0) {
      b.live[w] = m;
      b.esc[w] = 0u;
    }
  }
  if (tid == 0) {
    esc_hi = -1;
    n = Counters{0, 0, 0, 0, 0};
  }
  __syncthreads();

  int parity = 0;
  int tests = 0;
  if (warp != 0) {  // the other warps join only escaped rows' full scans
    for (;;) {
      bar1();
      const int i = cmd[0], j0 = cmd[1];
      if (i < 0) break;
      full_scan(i, j0, b, in, out, p, n, warp_first, parity);
    }
  } else {
    int above = 0;  // live bodies at or above row i
    for (int w = lane; w < nw; w += 32) above += __popc(b.live[w]);
    above = __reduce_add_sync(kFull, above);
    for (int i = 0; i < c; ++i) {
      // the next row with work, 32 rows a step: live, and near words, an
      // escaped body above it, or escaped itself; a live row without work
      // tests its every live body above and changes nothing (state read in
      // shared memory after __syncwarp, uniform across the warp)
      const int r0 = min(i, c - 1);  // first the row after the last: with near words, it has work
      int row = (i < c) & (b.span[r0] != 0u) & b.is_live(r0) ? i : -1;
      for (; row < 0 && i < c; i += 32) {
        const int r = min(i + lane, c - 1);
        const bool lv = (i + lane < c) & b.is_live(r);
        const bool work = (b.span[r] != 0u) | (*b.esc_hi > r) | b.escaped(r);
        const unsigned wb = __ballot_sync(kFull, lv & work);
        const unsigned lb = __ballot_sync(kFull, lv);
        const int k = wb ? __ffs(wb) - 1 : 32;
        const int idle = __popc(k == 32 ? lb : lb & ((1u << k) - 1u));
        tests += idle * above - idle * (idle + 1) / 2;
        above -= idle;
        if (wb) row = i + k;
      }
      if (row < 0) break;
      i = row;
      --above;
      int j0 = i + 1, fired = -1;
      if (!b.escaped(i)) fired = walk_row(i, j0, b, near + static_cast<size_t>(i) * nw, in, out, p, n);
      if (j0 < c) {  // i escaped: the rest of the row with the whole block
        if (lane == 0) {
          cmd[0] = i;
          cmd[1] = j0;
        }
        __syncwarp();
        bar1();
        fired = full_scan(i, j0, b, in, out, p, n, warp_first, parity);
      }
      if (fired >= 0) {  // its live candidates up to the partner, which was live
        tests += live_between(i, fired, b) + 1;
        --above;
      } else {
        tests += above;
      }
    }
    if (lane == 0) cmd[0] = -1;
    __syncwarp();
    bar1();
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
    out.removed[k] = (in.alive[k] && !b.is_live(k)) ? 1 : 0;
  }
  if (tid == 0) {
    out.counts[0] = n.n_bounces;
    out.counts[1] = n.m_cnt;
    out.counts[2] = n.m_drop;
    out.counts[3] = n.f_cnt;
    out.counts[4] = n.f_drop;
    out.counts[5] = tests;
  }
}

}  // namespace

// One sweep on `stream`: the body inputs, the timers in, the outputs (none
// filled by the caller), the scratch near bitmask [c, ceil(c/32)] and spans
// [c] (uint32), the sizes and the constants. stages: 1 the pre-pass alone, 2
// the walk alone (on the scratch a pre-pass left), 3 both (a sweep).
extern "C" int nbx_collide_sequential(const void* pos, const void* vel, const void* temp, const void* mass,
                                      const void* radius, const void* inv_m, const void* mat, const void* alive,
                                      const void* contact, void* pos_out, void* vel_out, void* temp_out,
                                      void* removed_out, void* contact_out, void* counts, void* mbuf, void* mmat,
                                      void* fbuf, void* fmat, void* near, void* span, int c, int mm, int ff,
                                      int stages, float h, float merge_time, float merge_q, float fracture_q,
                                      float min_fragment_mass, float correction, float restitution1, float friction,
                                      void* stream) {
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
  const int nw = (c + 31) / 32;
  const Params p{c, mm, ff, h, merge_time, merge_q, fracture_q, min_fragment_mass, correction,
                 restitution1, friction};
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (c <= 0) return static_cast<int>(cudaSuccess);
  if (stages & 1) {
    const int blocks = (c + kNearWarps - 1) / kNearWarps;
    near_kernel<<<blocks, kNearWarps * 32, 0, s>>>(static_cast<const float*>(pos), static_cast<const float*>(radius),
                                                   c, static_cast<unsigned*>(near), static_cast<unsigned*>(span),
                                                   out, mm, ff);
    const cudaError_t err = cudaGetLastError();
    if (err != cudaSuccess) return static_cast<int>(err);
  }
  if (stages & 2) {
    const int smem = 40 * c + 8 * nw;
    static int allowed[16] = {};  // the dynamic shared memory the walk may take, by device
    int dev = 0;
    cudaError_t err = cudaGetDevice(&dev);
    if (err != cudaSuccess) return static_cast<int>(err);
    if (smem > 48 * 1024 && smem > allowed[dev & 15]) {
      err = cudaFuncSetAttribute(walk_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
      if (err != cudaSuccess) return static_cast<int>(err);
      allowed[dev & 15] = smem;
    }
    walk_kernel<<<1, kThreads, smem, s>>>(in, out, p, static_cast<const unsigned*>(near),
                                          static_cast<const unsigned*>(span));
    err = cudaGetLastError();
    if (err != cudaSuccess) return static_cast<int>(err);
  }
  return static_cast<int>(cudaSuccess);
}
