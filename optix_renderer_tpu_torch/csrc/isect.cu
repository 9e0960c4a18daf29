// Closest-hit and any-hit kernels of the general path for Hopper (sm_90a),
// one thread per ray.
//
// Replaces three TPU kernels that compute one function, the closest (or any)
// hit of a ray wavefront against the triangle table:
//   * optix_renderer_tpu/ops/pallas/cluster.py: cluster_raw -> _cluster_kernel
//     (> 8192 triangles, Morton clusters of 256 swept as bf16 hi/lo matmuls
//     behind an XLA-built worklist)            -> isect_bvh<false / true>
//   * optix_renderer_tpu/ops/pallas/mxu_intersect.py: mxu_raw -> _mxu_kernel
//     (<= 8192 triangles as a [256,16] @ [16,512] matmul)   -> isect_brute
//   * optix_renderer_tpu/ops/pallas/mt_kernel.py: _mt_pallas -> _mt_kernel
//     (brute-force Moller-Trumbore with a fused argmin)     -> isect_brute
// The Pallas kernels take those shapes because Mosaic cannot gather per
// lane. On Hopper each thread owns one ray and walks the packed LBVH of
// ops/bvh.py with ordinary loads, as the JAX package's CPU walk does
// (ops/bvh.py: _traverse_walk; the walk is csrc/walk.cuh, which the path
// kernel's medium branch shares), or sweeps the triangle table in
// shared-memory tiles.
//
// What bounds them on this card:
//   * isect_bvh: the latency of dependent loads. Each step reads one 32-byte
//     node and, for a leaf whose box is hit, one 160-byte leaf row before it
//     knows where to go next; a few dozen FP32 operations per step cannot
//     hide that. The design keeps each step to two 16-byte __ldg loads per
//     node and ten per leaf (read-only path, L1/L2-resident for scenes of
//     ~100k triangles: 3.2 MB of nodes, 4 MB of leaves), keeps no stack (the
//     skip links make the walk a single cursor) and stops an any-hit walk at
//     its first confirmed hit.
//   * isect_brute: FP32 ALU work, ~40 operations per ray-triangle pair. A
//     block stages tiles of up to 256 triangles (v0, e1, e2) in shared memory
//     and every thread of the block sweeps the same tile, so the table is
//     read from device memory once per block and each read is a broadcast.
//
// Contract (ops/cuda/isect.py; plain versions ops/bvh.py: traverse_walk_ref
// and ops/cuda/isect.py: mt_sweep_ref): o, d [N,3], mint, cutoff [N] float32
// in; id [N] int32 (-1 on a miss) and t, u, v [N] float32 out (t = cutoff,
// u = v = 0 on a miss). A hit needs mint <= t < best; candidates are taken
// in order with strict <, so among equal t the first wins (leaf slot order
// in the walk, lowest index in the sweep: an argmin's tie-break). The
// arithmetic and its order are the plain versions', and the library is
// built without FMA contraction (ops/cuda/_build.py), so ids equal theirs.
//
// The per-ray functions are HD: device code under nvcc, plain inline C++
// under a host compiler, so the walk and the sweep can be checked against
// the plain versions without a GPU.
#include "walk.cuh"

namespace isect {

constexpr int TILE = 256;  // triangles per shared-memory tile of the sweep

// One ray against `cnt` triangles of a [cnt, 9] tile whose first triangle
// has global index `base` (ops/cuda/isect.py: mt_sweep_ref).
HD void sweep(const float* tile, int base, int cnt, const RayIn& r, Best& b) {
  for (int j = 0; j < cnt; ++j) {
    float t, u, v;
    if (mt(r, tile + 9 * j, t, u, v) && t >= r.mint && t < b.t) {
      b.t = t;
      b.u = u;
      b.v = v;
      b.id = base + j;
    }
  }
}

HD RayIn ray_at(const float* o, const float* d, const float* mint, int i) {
  RayIn r;
  r.ox = o[3 * i];
  r.oy = o[3 * i + 1];
  r.oz = o[3 * i + 2];
  r.dx = d[3 * i];
  r.dy = d[3 * i + 1];
  r.dz = d[3 * i + 2];
  r.mint = mint[i];
  return r;
}

#ifdef __CUDACC__
template <bool ANY>
__global__ void __launch_bounds__(128)
    bvh_kernel(const float* __restrict__ packed, int n_nodes, const float* __restrict__ leaf,
               const float* __restrict__ o, const float* __restrict__ d,
               const float* __restrict__ mint, const float* __restrict__ cutoff, int n,
               int* __restrict__ out_id, float* __restrict__ out_t, float* __restrict__ out_u,
               float* __restrict__ out_v, int* __restrict__ visits) {
  const int i = blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= n) return;
  const RayIn r = ray_at(o, d, mint, i);
  Best b = {cutoff[i], 0.0f, 0.0f, -1};
  int nodes, leaves;
  walk<ANY>(packed, n_nodes, leaf, r, b, nodes, leaves);
  out_id[i] = b.id;
  out_t[i] = b.t;
  out_u[i] = b.u;
  out_v[i] = b.v;
  if (visits) {
    visits[i] = nodes;
    visits[n + i] = leaves;
  }
}

__global__ void __launch_bounds__(TILE)
    brute_kernel(const float* __restrict__ tri, int t_cnt, const float* __restrict__ o,
                 const float* __restrict__ d, const float* __restrict__ mint,
                 const float* __restrict__ cutoff, int n, int* __restrict__ out_id,
                 float* __restrict__ out_t, float* __restrict__ out_u,
                 float* __restrict__ out_v) {
  __shared__ float tile[TILE * 9];
  const int i = blockIdx.x * blockDim.x + threadIdx.x;
  const bool live = i < n;
  RayIn r = {};
  Best b = {0.0f, 0.0f, 0.0f, -1};
  if (live) {
    r = ray_at(o, d, mint, i);
    b.t = cutoff[i];
  }
  for (int base = 0; base < t_cnt; base += TILE) {
    const int cnt = min(TILE, t_cnt - base);
    for (int k = threadIdx.x; k < cnt * 9; k += blockDim.x) tile[k] = tri[(size_t)base * 9 + k];
    __syncthreads();
    if (live) sweep(tile, base, cnt, r, b);
    __syncthreads();
  }
  if (!live) return;
  out_id[i] = b.id;
  out_t[i] = b.t;
  out_u[i] = b.u;
  out_v[i] = b.v;
}
#endif

}  // namespace isect

#ifdef __CUDACC__
// any_hit: 0 closest hit, 1 stop at the first confirmed hit. visits [2, n] (nodes
// visited, leaves tested per ray) may be null.
extern "C" int isect_bvh_launch(const float* packed, int n_nodes, const float* leaf,
                                const float* o, const float* d, const float* mint,
                                const float* cutoff, int n, int any_hit, int* out_id,
                                float* out_t, float* out_u, float* out_v, int* visits,
                                void* stream) {
  const int threads = 128;
  const int blocks = (n + threads - 1) / threads;
  cudaStream_t s = (cudaStream_t)stream;
  if (n > 0) {
    if (any_hit)
      isect::bvh_kernel<true><<<blocks, threads, 0, s>>>(packed, n_nodes, leaf, o, d, mint,
                                                          cutoff, n, out_id, out_t, out_u,
                                                          out_v, visits);
    else
      isect::bvh_kernel<false><<<blocks, threads, 0, s>>>(packed, n_nodes, leaf, o, d, mint,
                                                           cutoff, n, out_id, out_t, out_u,
                                                           out_v, visits);
  }
  return (int)cudaGetLastError();
}

// tri [t_cnt, 9] = v0 e1 e2 per row
extern "C" int isect_brute_launch(const float* tri, int t_cnt, const float* o, const float* d,
                                  const float* mint, const float* cutoff, int n, int* out_id,
                                  float* out_t, float* out_u, float* out_v, void* stream) {
  const int blocks = (n + isect::TILE - 1) / isect::TILE;
  cudaStream_t s = (cudaStream_t)stream;
  if (n > 0)
    isect::brute_kernel<<<blocks, isect::TILE, 0, s>>>(tri, t_cnt, o, d, mint, cutoff, n,
                                                       out_id, out_t, out_u, out_v);
  return (int)cudaGetLastError();
}
#endif
