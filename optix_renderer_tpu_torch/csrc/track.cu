// Delta and ratio tracking through voxel-grid media for Hopper (sm_90a).
//
// Replaces the two data-dependent loops of optix_renderer_tpu/ops/volume_grid.py,
// which have no Pallas kernel: delta_track (:124, Woodcock tracking to the
// next real collision) and ratio_track (:202, the transmittance estimate of
// a segment), each a lax.while_loop over the whole ray wavefront that runs
// until no lane is active, for at most MAX_STEPS iterations, and draws from
// every lane's pcg32 stream in every iteration, active or not (2 floats in
// delta tracking, 1 in ratio tracking). Plain versions (lockstep, as the
// JAX loops): ops/volume_grid.py delta_track_ref / ratio_track_ref.
//
// The design, simple and exact first. Each entry point is two launches:
//   1. walk: one thread per lane walks its lane to the end (its first real
//      collision or escape; for ratio tracking escape or T <= 1e-6), at
//      most MAX_STEPS iterations, drawing its own first 2k (or k) numbers,
//      the same numbers the lockstep loop gives that lane. It writes t_event
//      (+inf on escape) or T, and K, the tentative collisions inside the
//      volume. It counts its iterations; one warp reduction and one
//      atomicMax per warp give L, the lockstep loop's iteration count, for
//      the whole wavefront, on the device.
//   2. advance: every lane's state moves on by 2L (or L) draws by pcg32
//      jump-ahead (O(log L) 64-bit steps), which equals the lockstep result
//      with no host sync.
// Without FMA contraction (-fmad=false) and with logf / floorf and IEEE
// division, a lane's walk repeats the plain version's float operations in
// its order, so the outputs are equal bit for bit (t_event, T, K and the
// state words; chip_smoke.py phase 17).
//
// What bounds it on this card: a step reads one 32-byte corner row
// (Media.vol_corners, two 16-byte loads) at a data-dependent address and
// does ~80 FP32 operations (OPS_STEP in chip_smoke.py, a logf counted as
// one), so the least time is max(sum K x 32 B / 3.35 TB/s,
// sum K x 80 / 67 TFLOP/s) for the run's own sum K, plus each lane's
// 88 bytes in and out once and its ~40 operations of setup. A 128^3
// grid's corner stack is 68.7 MB, larger than the 50 MB L2, so a warp's
// scattered rows are served from L2 only where lanes share a neighbourhood;
// lanes of a warp also wait for the warp's longest walk. The design does
// nothing about either yet: lanes sorted by medium and position, the stack
// in bf16, or a brick cache in shared memory are a later PR's work.
//
// The per-lane walk and the jump-ahead are HD functions over plain pointers
// (mega.cuh), so they also compile with a host compiler for rehearsal.

#include "mega.cuh"

namespace track {

using pk::Pcg32;

constexpr int MAX_STEPS = 2048;  // volume_grid.py MAX_TRACK_STEPS
constexpr int THREADS = 128;
constexpr int MEDIUM_HETEROG = 2;  // scene.data.MediumType.HETEROG

struct Media {
  const int* type;         // [M]
  const float* sigma_a;    // [M,3]
  const float* sigma_s;    // [M,3]
  const float* dscale;     // [M] density scale
  const int* vol_id;       // [M]
  const float* bmin;       // [V,3]
  const float* bmax;       // [V,3]
  const int* dims;         // [V,3] (D,H,W) of each grid
  const float* majorant;   // [V]
  const float* corners;    // [V, (D+1)(H+1)(W+1), 8]
  int D, H, W;             // the padded grid
};

struct Lanes {
  const float* ro;         // [N,3]
  const float* rd;         // [N,3]
  const float* t_max;      // [N]
  const int* med;          // [N]
  const long long* st_hi;  // [N] the pcg32 state and increment as 32-bit words
  const long long* st_lo;
  const long long* inc_hi;
  const long long* inc_lo;
  int n;
};

HD int imin(int a, int b) { return a < b ? a : b; }
HD int imax(int a, int b) { return a > b ? a : b; }

HD void load_row(const float* row, float* c) {
#ifdef __CUDA_ARCH__
  const float4 a = __ldg(reinterpret_cast<const float4*>(row));
  const float4 b = __ldg(reinterpret_cast<const float4*>(row) + 1);
  c[0] = a.x; c[1] = a.y; c[2] = a.z; c[3] = a.w;
  c[4] = b.x; c[5] = b.y; c[6] = b.z; c[7] = b.w;
#else
  for (int k = 0; k < 8; ++k) c[k] = row[k];
#endif
}

// density_at: densityScale x the trilinear lookup at p, 0 outside the bbox
// (volume_grid.py _trilinear_at: one row of the corner stack, weights in
// (z, y, x) order, the 8 terms added in sequence)
HD float density(const Media& m, int mid, int vid, float px, float py, float pz) {
  const float* lo = m.bmin + 3 * vid;
  const float* hi = m.bmax + 3 * vid;
  const float rx = (px - lo[0]) / fmaxf(hi[0] - lo[0], 1e-20f);
  const float ry = (py - lo[1]) / fmaxf(hi[1] - lo[1], 1e-20f);
  const float rz = (pz - lo[2]) / fmaxf(hi[2] - lo[2], 1e-20f);
  const float fz = rz * (float)m.dims[3 * vid + 0] - 0.5f;
  const float fy = ry * (float)m.dims[3 * vid + 1] - 0.5f;
  const float fx = rx * (float)m.dims[3 * vid + 2] - 0.5f;
  const float z0 = floorf(fz), y0 = floorf(fy), x0 = floorf(fx);
  const float wz = fz - z0, wy = fy - y0, wx = fx - x0;
  const int bz = imin(imax((int)z0 + 1, 0), m.D);
  const int by = imin(imax((int)y0 + 1, 0), m.H);
  const int bx = imin(imax((int)x0 + 1, 0), m.W);
  const int flat = (bz * (m.H + 1) + by) * (m.W + 1) + bx;
  const long long rows = (long long)(m.D + 1) * (m.H + 1) * (m.W + 1);
  float c[8];
  load_row(m.corners + ((long long)vid * rows + flat) * 8, c);
  const float az = 1.0f - wz, ay = 1.0f - wy, ax = 1.0f - wx;
  float d = c[0] * (az * ay * ax);
  d = d + c[1] * (az * ay * wx);
  d = d + c[2] * (az * wy * ax);
  d = d + c[3] * (az * wy * wx);
  d = d + c[4] * (wz * ay * ax);
  d = d + c[5] * (wz * ay * wx);
  d = d + c[6] * (wz * wy * ax);
  d = d + c[7] * (wz * wy * wx);
  const bool inside = px >= lo[0] && px <= hi[0] && py >= lo[1] && py <= hi[1] &&
                      pz >= lo[2] && pz <= hi[2];
  return m.dscale[mid] * (inside ? d : 0.0f);
}

struct Walk {
  float out;     // delta: t_event (+inf on escape); ratio: T
  int k;         // tentative collisions inside the volume
  int iters;     // iterations the lane stayed active
};

// One lane to its end, drawing from its own stream p (volume_grid.py
// delta_track / ratio_track: _bbox_clip, _majorant, the loop body).
template <bool RATIO>
HD Walk walk_lane(const Media& m, const Lanes& l, int i, Pcg32 p) {
  Walk w{RATIO ? 1.0f : INFINITY, 0, 0};
  const int med = l.med[i];
  const int mid = imax(med, 0);
  if (!(med >= 0 && m.type[mid] == MEDIUM_HETEROG)) return w;
  const int vid = imax(m.vol_id[mid], 0);
  const float ox = l.ro[3 * i], oy = l.ro[3 * i + 1], oz = l.ro[3 * i + 2];
  const float dx = l.rd[3 * i], dy = l.rd[3 * i + 1], dz = l.rd[3 * i + 2];
  // _bbox_clip over [0, t_max]
  const float* lo = m.bmin + 3 * vid;
  const float* hi = m.bmax + 3 * vid;
  const float ix = 1.0f / (fabsf(dx) > 1e-20f ? dx : 1e-20f);
  const float iy = 1.0f / (fabsf(dy) > 1e-20f ? dy : 1e-20f);
  const float iz = 1.0f / (fabsf(dz) > 1e-20f ? dz : 1e-20f);
  const float tax = (lo[0] - ox) * ix, tbx = (hi[0] - ox) * ix;
  const float tay = (lo[1] - oy) * iy, tby = (hi[1] - oy) * iy;
  const float taz = (lo[2] - oz) * iz, tbz = (hi[2] - oz) * iz;
  const float near = fmaxf(fmaxf(fminf(tax, tbx), fminf(tay, tby)), fminf(taz, tbz));
  const float far = fminf(fminf(fmaxf(tax, tbx), fmaxf(tay, tby)), fmaxf(taz, tbz));
  const float t0 = fmaxf(near, 0.0f);
  const float t1 = fminf(far, l.t_max[i]);
  // _majorant: max_c(sigma_t) x max(densityScale x maxDensity, 1e-3)
  const float* sa = m.sigma_a + 3 * mid;
  const float* ss = m.sigma_s + 3 * mid;
  const float st_max = fmaxf(fmaxf(sa[0] + ss[0], sa[1] + ss[1]), sa[2] + ss[2]);
  const float M = st_max * fmaxf(m.dscale[mid] * m.majorant[vid], 1e-3f);
  if (!(t0 <= t1 && M > 1e-12f)) return w;
  const float Mc = fmaxf(M, 1e-20f);
  float t = t0;
  while (w.iters < MAX_STEPS) {
    const float u1 = pk::draw1(p);
    const float u2 = RATIO ? 0.0f : pk::draw1(p);
    ++w.iters;
    const float tn = t - logf(fmaxf(1.0f - u1, 1e-38f)) / Mc;
    if (tn > t1) break;  // escaped the segment or the volume
    const float rho = density(m, mid, vid, ox + dx * tn, oy + dy * tn, oz + dz * tn);
    ++w.k;
    if (RATIO) {
      w.out = w.out * fmaxf(1.0f - rho * st_max / Mc, 0.0f);
      if (!(w.out > 1e-6f)) break;
    } else if (rho * st_max / Mc >= u2) {
      w.out = tn;  // a real collision
      break;
    }
    t = tn;
  }
  return w;
}

// pcg32 jump-ahead by `delta` steps (pcg32.h advance)
HD uint64_t advance(uint64_t state, uint64_t inc, uint64_t delta) {
  uint64_t cur_mult = pk::PCG32_MULT, cur_plus = inc, acc_mult = 1u, acc_plus = 0u;
  while (delta > 0u) {
    if (delta & 1u) {
      acc_mult *= cur_mult;
      acc_plus = acc_plus * cur_mult + cur_plus;
    }
    cur_plus = (cur_mult + 1u) * cur_plus;
    cur_mult *= cur_mult;
    delta >>= 1u;
  }
  return acc_mult * state + acc_plus;
}

HD Pcg32 lane_state(const Lanes& l, int i) {
  Pcg32 p;
  p.state = ((uint64_t)(uint32_t)l.st_hi[i] << 32) | (uint32_t)l.st_lo[i];
  p.inc = ((uint64_t)(uint32_t)l.inc_hi[i] << 32) | (uint32_t)l.inc_lo[i];
  return p;
}

#ifdef __CUDACC__

template <bool RATIO>
__global__ void __launch_bounds__(THREADS) walk_kernel(Media m, Lanes l, float* out, int* k,
                                                       unsigned* iters_max) {
  const int i = blockIdx.x * THREADS + threadIdx.x;
  int iters = 0;
  if (i < l.n) {
    const Walk w = walk_lane<RATIO>(m, l, i, lane_state(l, i));
    out[i] = w.out;
    k[i] = w.k;
    iters = w.iters;
  }
  const unsigned warp_max = __reduce_max_sync(0xffffffffu, (unsigned)iters);
  if ((threadIdx.x & 31) == 0 && warp_max > 0u) atomicMax(iters_max, warp_max);
}

__global__ void __launch_bounds__(THREADS) advance_kernel(Lanes l, const unsigned* iters_max,
                                                          unsigned draws_per_iter,
                                                          long long* new_hi, long long* new_lo) {
  const int i = blockIdx.x * THREADS + threadIdx.x;
  if (i >= l.n) return;
  const Pcg32 p = lane_state(l, i);
  const uint64_t s = advance(p.state, p.inc, (uint64_t)(*iters_max) * draws_per_iter);
  new_hi[i] = (long long)(s >> 32);
  new_lo[i] = (long long)(s & 0xffffffffu);
}

#endif  // __CUDACC__

}  // namespace track

#ifdef __CUDACC__

// ratio = 0: delta tracking (out = t_event), 1: ratio tracking (out = T).
// iters_max: one device uint32, set to L. Returns a cudaError_t code.
extern "C" int track_launch(int ratio, const float* ro, const float* rd, const float* t_max,
                            const int* med, int n, const long long* st_hi,
                            const long long* st_lo, const long long* inc_hi,
                            const long long* inc_lo, const int* m_type, const float* m_sa,
                            const float* m_ss, const float* m_dscale, const int* m_vid,
                            const float* v_bmin, const float* v_bmax, const int* v_dims,
                            const float* v_major, const float* corners, int D, int H, int W,
                            float* out, int* k, long long* new_hi, long long* new_lo,
                            unsigned* iters_max, void* stream) {
  if (n <= 0 || iters_max == nullptr || corners == nullptr ||
      (reinterpret_cast<uintptr_t>(corners) & 15u) != 0u)
    return (int)cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const track::Media m{m_type, m_sa, m_ss, m_dscale, m_vid, v_bmin, v_bmax, v_dims,
                       v_major, corners, D, H, W};
  const track::Lanes l{ro, rd, t_max, med, st_hi, st_lo, inc_hi, inc_lo, n};
  cudaError_t e = cudaMemsetAsync(iters_max, 0, sizeof(unsigned), s);
  if (e != cudaSuccess) return (int)e;
  const int blocks = (n + track::THREADS - 1) / track::THREADS;
  if (ratio)
    track::walk_kernel<true><<<blocks, track::THREADS, 0, s>>>(m, l, out, k, iters_max);
  else
    track::walk_kernel<false><<<blocks, track::THREADS, 0, s>>>(m, l, out, k, iters_max);
  e = cudaGetLastError();
  if (e != cudaSuccess) return (int)e;
  track::advance_kernel<<<blocks, track::THREADS, 0, s>>>(l, iters_max, ratio ? 1u : 2u,
                                                          new_hi, new_lo);
  return (int)cudaGetLastError();
}

#endif  // __CUDACC__
