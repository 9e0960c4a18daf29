// Hopper probes (sm_90a): the CUDA counterparts of the repository's two
// Pallas probe kernels under tools/.
//
// probe_copy_kernel replaces tools/probe_mosaic.py: kern (pallas_call at :50),
// the probe of the primitives a culled cluster sweep needs: flags stored at
// dynamic indices into fast memory, then, per cluster with its flag set, a
// dynamic-index copy of one slab into fast memory and a row sum. On Hopper:
// flags in shared memory, and a TMA tensor copy (cp.async.bulk.tensor, the
// slab index a coordinate) guarded by the flag, completing on an mbarrier.
// Bound: the bytes of the 8 flagged slabs (2 MB), 0.6 us; a dependent copy
// -> sum -> combine cannot come near it, so the design spreads the copies
// over the card and keeps them all in flight: one CTA per (64-column tile,
// flagged slab), 128 CTAs, each copying its [64, 64] tile (16 KB) with one
// tensor copy (64 row copies of 256 B took 1.5 us more on an H100,
// PERF.md section 6). The 8 CTAs of a column tile form a thread-block
// cluster, rank k holding the k-th flagged slab, so the partial sums meet
// in distributed shared memory: each rank adds the 8 partials in c order
// and writes one output row. The sums keep probe_copy_ref's order (rows of
// a slab in turn, then the slabs in c order), so the result equals it bit
// for bit.
//
// iter_cost_kernel<MODE> replaces tools/prof_parts2.py: make -> kern
// (pallas_call at :40), the probe of the marginal cost of one loop
// iteration: NB groups of 4096 lanes (the TPU's [8, 512] block) run n_it
// iterations of one body: empty (acc + 1), reduce (the max of acc over the
// group every iteration), madd100 (100 dependent multiply-adds) or isect
// (the path kernel's Moller-Trumbore over 14 rows of a [16, 48] triangle
// table, closest hit and shadow test of one ray). A group is 4 CTAs of 1024
// threads, one lane per thread, so NB = 32 runs on 128 SMs. reduce launches
// each group as a thread-block cluster and takes the group max across its
// 4 CTAs through distributed shared memory (the cluster scheduler puts 8 of
// the 128 CTAs two to an SM: at one CTA per SM only 30 such clusters fit
// the H100's GPCs). The other modes launch plain CTAs: as clusters they
// shared SMs the same way and isect took twice as long. isect stages the
// table once per CTA in shared memory (every lane reads the same row: a
// broadcast), runs one test per triangle for both the closest and the
// shadow test (the shadow ray is the current ray, as in
// tools/prof_parts2.py), and takes the division's fast path in line
// (walk.cuh: rcp_fast) with one warp vote per triangle for the slow path.
// Bound: its FP32 operations, at most half the FP32 peak without FMA; in
// practice instruction issue.
//
// Both are built with the library's flags (ops/cuda/_build.py, -fmad=false),
// so their results equal their plain torch versions bit for bit.
#include "mega.cuh"
#include "walk.cuh"

#ifdef __CUDACC__
#include <cooperative_groups.h>
#include <cuda.h>  // CUtensorMap; cuTensorMapEncodeTiled is reached through the runtime
#include <cuda_runtime.h>

namespace probes {

namespace cg = cooperative_groups;

constexpr int PC_C = 16, PC_CS = 64, PC_W = 1024, PC_OUT_ROWS = 8;
constexpr int PC_COLS = 64;   // columns of a tile
constexpr int PC_SLABS = 8;   // flagged slabs (c % 2 == 1): CTAs per cluster
constexpr int PC_CTAS = PC_W / PC_COLS * PC_SLABS;
static_assert(PC_OUT_ROWS == PC_SLABS, "rank k of a cluster writes output row k");

constexpr int IC_LANES = 4096, IC_THREADS = 1024, IC_CTAS = IC_LANES / IC_THREADS;
constexpr int IC_TRIS = 14;
enum { MODE_EMPTY = 0, MODE_REDUCE = 1, MODE_MADD100 = 2, MODE_ISECT = 3 };

using pk::mbar_wait;
using pk::smem_u32;

__device__ __forceinline__ uint32_t sm_id() {
  uint32_t v;
  asm volatile("mov.u32 %0, %%smid;" : "=r"(v));
  return v;
}

__device__ __forceinline__ uint32_t cluster_ctas() {
  uint32_t v;
  asm volatile("mov.u32 %0, %%cluster_nctarank;" : "=r"(v));
  return v;
}

// info [grid, 2] (optional): the SM each CTA ran on and its cluster's CTAs
__device__ __forceinline__ void record(int* info) {
  if (info && threadIdx.x == 0) {
    info[2 * blockIdx.x] = (int)sm_id();
    info[2 * blockIdx.x + 1] = (int)cluster_ctas();
  }
}

// the address of the same shared variable in CTA `rank` of the cluster
__device__ __forceinline__ uint32_t remote(uint32_t addr, int rank) {
  uint32_t r;
  asm volatile("mapa.shared::cluster.u32 %0, %1, %2;" : "=r"(r) : "r"(addr), "r"(rank));
  return r;
}

__device__ __forceinline__ void mbar_init(uint32_t bar, uint32_t count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;" ::"r"(bar), "r"(count) : "memory");
  asm volatile("fence.mbarrier_init.release.cluster;" ::: "memory");
}

// wait on an mbarrier phase whose arrivals come from the whole cluster
__device__ __forceinline__ void cluster_wait(uint32_t bar, uint32_t parity) {
  uint32_t done = 0;
  do {
    asm volatile(
        "{\n"
        ".reg .pred p;\n"
        "mbarrier.try_wait.parity.acquire.cluster.shared::cta.b64 p, [%1], %2;\n"
        "selp.u32 %0, 1, 0, p;\n"
        "}\n"
        : "=r"(done)
        : "r"(bar), "r"(parity)
        : "memory");
  } while (!done);
}

// x [C, CS, W] float32, sel [C] int32 -> out [8, W], every row the sum over
// the flagged clusters c (c % 2 == 1), in c order, of the column sums of
// slab sel[c]. `map` is x's tensor map with a [1, CS, PC_COLS] box. Cluster
// = column tile; rank k = the k-th flagged slab.
__global__ void __cluster_dims__(PC_SLABS, 1, 1) __launch_bounds__(PC_COLS)
    probe_copy_kernel(const int* __restrict__ sel, float* __restrict__ out, int* info,
                      const __grid_constant__ CUtensorMap map) {
  __shared__ alignas(128) float buf[PC_CS * PC_COLS];
  __shared__ float flags[PC_C];
  __shared__ float part[PC_COLS];
  __shared__ alignas(8) uint64_t bar;
  cg::cluster_group cluster = cg::this_cluster();
  const int tid = threadIdx.x;
  const int k = (int)cluster.block_rank();
  const int col0 = (blockIdx.x / PC_SLABS) * PC_COLS;
  const uint32_t bar_a = smem_u32(&bar);
  record(info);

  // 1. flags stored at dynamic indices
  for (int c = tid; c < PC_C; c += blockDim.x) flags[c] = (float)(c % 2);
  if (tid == 0) mbar_init(bar_a, 1);
  __syncthreads();

  // 2. the k-th flagged cluster's slab: a flag-guarded tensor copy of the
  // tile, then its rows added in turn
  int ck = -1;
  for (int c = 0, n = 0; c < PC_C && ck < 0; ++c)
    if (flags[c] > 0.5f && n++ == k) ck = c;
  float s = 0.0f;
  if (ck >= 0) {  // the same branch for the whole CTA
    if (tid == 0) {
      asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;" ::"r"(bar_a),
                   "r"((uint32_t)sizeof(buf))
                   : "memory");
      asm volatile(
          "cp.async.bulk.tensor.3d.shared::cluster.global.mbarrier::complete_tx::bytes [%0], "
          "[%1, {%2, %3, %4}], [%5];" ::"r"(smem_u32(buf)),
          "l"(reinterpret_cast<uint64_t>(&map)), "r"(col0), "r"(0), "r"(sel[ck]), "r"(bar_a)
          : "memory");
    }
    mbar_wait(bar_a, 0);
#pragma unroll 16
    for (int r = 0; r < PC_CS; ++r) s += buf[r * PC_COLS + tid];
  }
  part[tid] = s;
  cluster.sync();

  // 3. the partials in c order (rank order); a rank without a slab adds +0,
  // which leaves the sum (never -0) as it is
  float acc = 0.0f;
#pragma unroll
  for (int q = 0; q < PC_SLABS; ++q) acc += *cluster.map_shared_rank(&part[tid], q);
  out[k * PC_W + col0 + tid] = acc;
  cluster.sync();  // no CTA leaves while another may still read its part
}

// the latency floor: nothing, in probe_copy_kernel's grid and clusters
__global__ void __cluster_dims__(PC_SLABS, 1, 1) __launch_bounds__(PC_COLS) empty_kernel() {}

// x [NB, 8, 4096] float32 (lane rows of the TPU probe's [NB, 8, 8, 512]),
// tri [16, 48] -> out [8, NB, 4096], every row the lane's acc after n_it
// iterations. CTA blockIdx.x serves group blockIdx.x / 4, lanes
// (blockIdx.x % 4) * 1024 + threadIdx.x (tools/prof_parts.py: lane_map);
// for reduce the group is a cluster and blockIdx.x % 4 its rank.
template <int MODE>
__global__ void __launch_bounds__(IC_THREADS) iter_cost_kernel(const float* __restrict__ x,
                                                               const float* __restrict__ tri,
                                                               float* __restrict__ out,
                                                               int n_it, int* info) {
  __shared__ __align__(16) float table[MODE == MODE_ISECT ? IC_TRIS * pk::TR_COLS : 1];
  __shared__ float red[IC_THREADS / 32];
  __shared__ float slots[2][IC_CTAS];
  __shared__ alignas(8) uint64_t slot_bar[2];
  const int tid = threadIdx.x;
  const int b = blockIdx.x / IC_CTAS, nb = gridDim.x / IC_CTAS;
  const int rank = blockIdx.x % IC_CTAS;
  const int lane = rank * IC_THREADS + tid;
  record(info);
  if constexpr (MODE == MODE_ISECT) {
    for (int k = tid; k < IC_TRIS * pk::TR_COLS; k += IC_THREADS) table[k] = tri[k];
    __syncthreads();
  }
  if constexpr (MODE == MODE_REDUCE) {
    if (tid < 2) mbar_init(smem_u32(&slot_bar[tid]), IC_CTAS);
    cg::this_cluster().sync();  // every barrier initialised before any remote arrive
  }
  float acc = x[(size_t)b * 8 * IC_LANES + lane] * 0.0f;

  for (int it = 0; it < n_it; ++it) {
    if constexpr (MODE == MODE_EMPTY) {
      acc = acc + 1.0f;
    } else if constexpr (MODE == MODE_REDUCE) {
      // the group max: warps, then the CTA (warp 0), whose lane q stores
      // the CTA's max into slot [it & 1][rank] of CTA q of the cluster and
      // arrives on that CTA's barrier for the slot; every thread waits on
      // its own CTA's barrier (4 arrivals) and takes the max of the 4
      // slots. A CTA writes a slot again two iterations later, after its
      // own wait of the iteration between, which needs every CTA's
      // arrival, each made after that CTA read the slot.
      const int s = it & 1;
      float m = acc;
      for (int off = 16; off > 0; off >>= 1) m = fmaxf(m, __shfl_xor_sync(0xffffffffu, m, off));
      if ((tid & 31) == 0) red[tid >> 5] = m;
      __syncthreads();
      if (tid < 32) {
        m = red[tid];
        for (int off = 16; off > 0; off >>= 1) m = fmaxf(m, __shfl_xor_sync(0xffffffffu, m, off));
        if (tid < IC_CTAS) {
          const uint32_t slot = remote(smem_u32(&slots[s][rank]), tid);
          const uint32_t bar = remote(smem_u32(&slot_bar[s]), tid);
          asm volatile("st.shared::cluster.f32 [%0], %1;" ::"r"(slot), "f"(m) : "memory");
          asm volatile("mbarrier.arrive.release.cluster.shared::cluster.b64 _, [%0];" ::"r"(bar)
                       : "memory");
        }
      }
      cluster_wait(smem_u32(&slot_bar[s]), (it >> 1) & 1);
      m = slots[s][0];
#pragma unroll
      for (int q = 1; q < IC_CTAS; ++q) m = fmaxf(m, slots[s][q]);
      acc = acc + m * 1e-12f + 1.0f;
    } else if constexpr (MODE == MODE_MADD100) {
      float y = acc;
#pragma unroll
      for (int i = 0; i < 100; ++i) y = y * 1.000001f + 0.5f;
      acc = acc + y * 1e-12f;
    } else {  // MODE_ISECT: pathk._isect's contract, one test per triangle
      const isect::RayIn r{acc, acc + 1.0f, acc + 2.0f, 0.3f, 0.5f, -0.8f, 0.0f};
      float t_best = 1e9f;
      int best_j = -1;
      bool occ = false;
      for (int j = 0; j < IC_TRIS; ++j) {
        float row[12];  // v0 e1 e2 (and 3 more columns): three 16-byte broadcast loads
        for (int k = 0; k < 12; k += 4) isect::load4<true>(table + j * pk::TR_COLS + k, row + k);
        const isect::MtNum m = isect::mt_num(r, row);
        const float div = isect::mt_divisor(m);
        float inv = isect::rcp_fast(div);
        if (__any_sync(0xffffffffu, !isect::rcp_in_range(div))) inv = 1.0f / div;
        float t, u, v;
        const bool hit = isect::mt_hit(m, inv, t, u, v);
        // the closest test ([0, t_best)) and the shadow test ([EPS, 5)) of
        // the same ray share the hit
        if (hit && t >= 0.0f && t < t_best) {
          t_best = t;
          best_j = j;
        }
        occ = occ || (hit && t >= pk::EPS && t < 5.0f);
      }
      const float kdr = best_j >= 0 ? table[best_j * pk::TR_COLS + 26] : 0.0f;
      // the occlusion bit joins acc (adding 0 when not occluded) so the
      // shadow test is not removed
      acc = acc + t_best * 1e-12f + kdr * 1e-12f + (occ ? 1e-12f : 0.0f);
    }
  }
  for (int r = 0; r < 8; ++r) out[((size_t)r * nb + b) * IC_LANES + lane] = acc;
  if constexpr (MODE == MODE_REDUCE)
    cg::this_cluster().sync();  // no CTA leaves while another may still reach its memory
}

template <int MODE>
cudaError_t launch_iter_cost(const float* x, const float* tri, float* out, int nb, int n_it,
                             int* info, cudaStream_t s) {
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(nb * IC_CTAS);
  cfg.blockDim = dim3(IC_THREADS);
  cfg.stream = s;
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeClusterDimension;
  attr[0].val.clusterDim.x = IC_CTAS;
  attr[0].val.clusterDim.y = 1;
  attr[0].val.clusterDim.z = 1;
  cfg.attrs = attr;
  cfg.numAttrs = MODE == MODE_REDUCE ? 1 : 0;
  return cudaLaunchKernelEx(&cfg, iter_cost_kernel<MODE>, x, tri, out, n_it, info);
}

// x's tensor map: [C, CS, W] float32 with a box of [1, CS, PC_COLS]
cudaError_t slab_map(const float* x, CUtensorMap* map) {
  using EncodeTiled = decltype(&cuTensorMapEncodeTiled);
  static EncodeTiled encode = nullptr;
  if (!encode) {
    cudaDriverEntryPointQueryResult q;
    const cudaError_t e = cudaGetDriverEntryPoint("cuTensorMapEncodeTiled", (void**)&encode,
                                                  cudaEnableDefault, &q);
    if (e != cudaSuccess) return e;
    if (q != cudaDriverEntryPointSuccess || !encode) {
      encode = nullptr;
      return cudaErrorSymbolNotFound;
    }
  }
  const cuuint64_t dims[3] = {PC_W, PC_CS, PC_C};
  const cuuint64_t strides[2] = {PC_W * sizeof(float), (cuuint64_t)PC_CS * PC_W * sizeof(float)};
  const cuuint32_t box[3] = {PC_COLS, PC_CS, 1};
  const cuuint32_t elem[3] = {1, 1, 1};
  const CUresult r = encode(map, CU_TENSOR_MAP_DATA_TYPE_FLOAT32, 3, (void*)x, dims, strides, box,
                            elem, CU_TENSOR_MAP_INTERLEAVE_NONE, CU_TENSOR_MAP_SWIZZLE_NONE,
                            CU_TENSOR_MAP_L2_PROMOTION_NONE, CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE);
  return r == CUDA_SUCCESS ? cudaSuccess : cudaErrorInvalidValue;
}

}  // namespace probes

// info: null, or int32 [128, 2] that receives each CTA's SM and cluster size
extern "C" int probe_copy_launch(const float* x, const int* sel, float* out, int* info,
                                 void* stream) {
  using namespace probes;
  CUtensorMap map;
  const cudaError_t e = slab_map(x, &map);
  if (e != cudaSuccess) return (int)e;
  probe_copy_kernel<<<PC_CTAS, PC_COLS, 0, (cudaStream_t)stream>>>(sel, out, info, map);
  return (int)cudaGetLastError();
}

extern "C" int probe_empty_launch(void* stream) {
  probes::empty_kernel<<<probes::PC_CTAS, probes::PC_COLS, 0, (cudaStream_t)stream>>>();
  return (int)cudaGetLastError();
}

// info: null, or int32 [nb * 4, 2] that receives each CTA's SM and cluster size
extern "C" int iter_cost_launch(const float* x, const float* tri, float* out, int nb, int n_it,
                                int mode, int* info, void* stream) {
  using namespace probes;
  cudaStream_t s = (cudaStream_t)stream;
  cudaError_t e = cudaSuccess;
  if (nb > 0) {
    if (mode == MODE_EMPTY)
      e = launch_iter_cost<MODE_EMPTY>(x, tri, out, nb, n_it, info, s);
    else if (mode == MODE_REDUCE)
      e = launch_iter_cost<MODE_REDUCE>(x, tri, out, nb, n_it, info, s);
    else if (mode == MODE_MADD100)
      e = launch_iter_cost<MODE_MADD100>(x, tri, out, nb, n_it, info, s);
    else if (mode == MODE_ISECT)
      e = launch_iter_cost<MODE_ISECT>(x, tri, out, nb, n_it, info, s);
    else
      return (int)cudaErrorInvalidValue;
  }
  if (e != cudaSuccess) return (int)e;
  return (int)cudaGetLastError();
}
#endif
