// Hopper probes (sm_90a): the CUDA counterparts of the repository's two
// Pallas probe kernels under tools/.
//
// probe_copy_kernel replaces tools/probe_mosaic.py: kern (pallas_call at :50),
// the probe of the primitives a culled cluster sweep needs: flags stored at
// dynamic indices into fast memory, then, per cluster with its flag set, a
// dynamic-index copy of one slab into fast memory and a row sum. On Hopper:
// flags in shared memory, and a TMA bulk copy (cp.async.bulk) guarded by the
// flag, completing on an mbarrier. A [64, 1024] slab is 256 KB, more than a
// block's shared memory, so W is split over blocks: each block owns
// PC_COLS = 128 columns and copies its [64, 128] tile (32 KB) as 64 row
// copies of 512 B. Bound: the bytes of the flagged slabs (2 MB), a few us.
//
// iter_cost_kernel<MODE> replaces tools/prof_parts2.py: make -> kern
// (pallas_call at :40), the probe of the marginal cost of one loop
// iteration: NB = 32 groups of 4096 lanes (the TPU's [8, 512] block), each
// a CUDA block of 1024 threads with 4 lanes per thread, runs n_it
// iterations of one body: empty (acc + 1), reduce (a block-wide max of acc
// every iteration), madd100 (100 dependent multiply-adds) or isect (the path
// kernel's Moller-Trumbore, mt_hit, on the current ray and on the shadow
// ray over 14 rows of a [16, 48] triangle table). Bound: its FP32
// operations; reduce adds a __syncthreads per iteration.
//
// Both are built with the library's flags (ops/cuda/_build.py, -fmad=false),
// so their results equal their plain torch versions bit for bit.
#include "mega.cuh"

#ifdef __CUDACC__
#include <cuda_runtime.h>

namespace probes {

constexpr int PC_C = 16, PC_CS = 64, PC_W = 1024, PC_COLS = 128, PC_OUT_ROWS = 8;
constexpr int IC_LANES = 4096, IC_THREADS = 1024, IC_LPT = IC_LANES / IC_THREADS;
constexpr int IC_TRIS = 14;
enum { MODE_EMPTY = 0, MODE_REDUCE = 1, MODE_MADD100 = 2, MODE_ISECT = 3 };

using pk::mbar_wait;
using pk::smem_u32;

// x [C, CS, W] float32, sel [C] int32 -> out [8, W], every row the sum over
// the flagged clusters c (c % 2 == 1) of the column sums of slab sel[c]
__global__ void __launch_bounds__(PC_COLS) probe_copy_kernel(const float* __restrict__ x,
                                                             const int* __restrict__ sel,
                                                             float* __restrict__ out) {
  __shared__ alignas(128) float buf[PC_CS * PC_COLS];
  __shared__ float flags[PC_C];
  __shared__ alignas(8) uint64_t bar;
  const int tid = threadIdx.x;
  const int col0 = blockIdx.x * PC_COLS;
  const uint32_t bar_a = smem_u32(&bar);

  // 1. flags stored at dynamic indices
  for (int c = tid; c < PC_C; c += blockDim.x) flags[c] = (float)(c % 2);
  if (tid == 0) {
    asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;" ::"r"(bar_a), "r"(1) : "memory");
    asm volatile("fence.mbarrier_init.release.cluster;" ::: "memory");
  }
  __syncthreads();

  // 2. visit loop: a flag-guarded bulk copy of slab sel[c], then a row sum
  float acc = 0.0f;
  uint32_t parity = 0;
  for (int c = 0; c < PC_C; ++c) {
    if (!(flags[c] > 0.5f)) continue;  // the same branch for the whole block
    if (tid == 0) {
      // the block's earlier reads of buf are ordered before the copy's writes
      asm volatile("fence.proxy.async.shared::cta;" ::: "memory");
      const uint32_t bytes = PC_CS * PC_COLS * sizeof(float);
      asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;" ::"r"(bar_a),
                   "r"(bytes)
                   : "memory");
      const float* src = x + (size_t)sel[c] * PC_CS * PC_W + col0;
      for (int r = 0; r < PC_CS; ++r)
        asm volatile(
            "cp.async.bulk.shared::cluster.global.mbarrier::complete_tx::bytes [%0], [%1], %2, "
            "[%3];" ::"r"(smem_u32(buf + r * PC_COLS)),
            "l"(src + (size_t)r * PC_W), "r"((uint32_t)(PC_COLS * sizeof(float))), "r"(bar_a)
            : "memory");
    }
    mbar_wait(bar_a, parity);
    parity ^= 1u;
    float s = 0.0f;
    for (int r = 0; r < PC_CS; ++r) s += buf[r * PC_COLS + tid];
    acc += s;
    __syncthreads();  // every thread is done with buf before the next copy
  }
  for (int r = 0; r < PC_OUT_ROWS; ++r) out[r * PC_W + col0 + tid] = acc;
}

// x [NB, 8, 4096] float32 (lane rows of the TPU probe's [NB, 8, 8, 512]),
// tri [16, 48] -> out [8, NB, 4096], every row the lane's acc after n_it
// iterations
template <int MODE>
__global__ void __launch_bounds__(IC_THREADS) iter_cost_kernel(const float* __restrict__ x,
                                                               const float* __restrict__ tri,
                                                               float* __restrict__ out,
                                                               int n_it) {
  __shared__ float red[IC_THREADS / 32];
  const int b = blockIdx.x, tid = threadIdx.x;
  float acc[IC_LPT];
  for (int k = 0; k < IC_LPT; ++k) acc[k] = x[(size_t)b * 8 * IC_LANES + tid + k * IC_THREADS] * 0.0f;

  for (int it = 0; it < n_it; ++it) {
    if (MODE == MODE_EMPTY) {
      for (int k = 0; k < IC_LPT; ++k) acc[k] = acc[k] + 1.0f;
    } else if (MODE == MODE_REDUCE) {
      float m = acc[0];
      for (int k = 1; k < IC_LPT; ++k) m = fmaxf(m, acc[k]);
      for (int off = 16; off > 0; off >>= 1) m = fmaxf(m, __shfl_xor_sync(0xffffffffu, m, off));
      if ((tid & 31) == 0) red[tid >> 5] = m;
      __syncthreads();
      m = red[0];
      for (int w = 1; w < IC_THREADS / 32; ++w) m = fmaxf(m, red[w]);
      __syncthreads();  // red is read by all before the next iteration writes it
      for (int k = 0; k < IC_LPT; ++k) acc[k] = acc[k] + m * 1e-12f + 1.0f;
    } else if (MODE == MODE_MADD100) {
      for (int k = 0; k < IC_LPT; ++k) {
        float y = acc[k];
#pragma unroll
        for (int i = 0; i < 100; ++i) y = y * 1.000001f + 0.5f;
        acc[k] = acc[k] + y * 1e-12f;
      }
    } else {  // MODE_ISECT: pathk._isect's contract with the path kernel's mt_hit
      for (int k = 0; k < IC_LPT; ++k) {
        const pk::V3 o{acc[k], acc[k] + 1.0f, acc[k] + 2.0f}, d{0.3f, 0.5f, -0.8f};
        float t_best = 1e9f, u, v, t;
        int best_j = -1;
        bool occ = false;
        for (int j = 0; j < IC_TRIS; ++j) {
          const float* tr = tri + j * pk::TR_COLS;
          if (pk::mt_hit(tr, o, d, u, v, t) && t >= 0.0f && t < t_best) {
            t_best = t;
            best_j = j;
          }
          if (!occ && pk::mt_hit(tr, o, d, u, v, t) && t >= pk::EPS && t < 5.0f) occ = true;
        }
        const float kdr = best_j >= 0 ? tri[best_j * pk::TR_COLS + 26] : 0.0f;
        // The shadow ray is the current ray, as in tools/prof_parts2.py, so
        // the compiler may share the two tests' arithmetic. The occlusion
        // bit joins acc (adding 0 when not occluded) so the any-hit logic
        // is not removed.
        acc[k] = acc[k] + t_best * 1e-12f + kdr * 1e-12f + (occ ? 1e-12f : 0.0f);
      }
    }
  }
  for (int r = 0; r < 8; ++r)
    for (int k = 0; k < IC_LPT; ++k)
      out[((size_t)r * gridDim.x + b) * IC_LANES + tid + k * IC_THREADS] = acc[k];
}

}  // namespace probes

extern "C" int probe_copy_launch(const float* x, const int* sel, float* out, void* stream) {
  probes::probe_copy_kernel<<<probes::PC_W / probes::PC_COLS, probes::PC_COLS, 0,
                              (cudaStream_t)stream>>>(x, sel, out);
  return (int)cudaGetLastError();
}

extern "C" int iter_cost_launch(const float* x, const float* tri, float* out, int nb, int n_it,
                                int mode, void* stream) {
  cudaStream_t s = (cudaStream_t)stream;
  const int t = probes::IC_THREADS;
  if (nb > 0) {
    if (mode == probes::MODE_EMPTY)
      probes::iter_cost_kernel<probes::MODE_EMPTY><<<nb, t, 0, s>>>(x, tri, out, n_it);
    else if (mode == probes::MODE_REDUCE)
      probes::iter_cost_kernel<probes::MODE_REDUCE><<<nb, t, 0, s>>>(x, tri, out, n_it);
    else if (mode == probes::MODE_MADD100)
      probes::iter_cost_kernel<probes::MODE_MADD100><<<nb, t, 0, s>>>(x, tri, out, n_it);
    else if (mode == probes::MODE_ISECT)
      probes::iter_cost_kernel<probes::MODE_ISECT><<<nb, t, 0, s>>>(x, tri, out, n_it);
    else
      return (int)cudaErrorInvalidValue;
  }
  return (int)cudaGetLastError();
}
#endif
