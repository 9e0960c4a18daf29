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
// (ops/bvh.py: _traverse_walk), or sweeps the triangle table in
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
#include <stdint.h>
#include <math.h>
#include <string.h>

#ifdef __CUDACC__
#include <cuda_runtime.h>
#define HD __device__ __forceinline__
#else
#define HD inline
#endif

namespace isect {

constexpr int LEAF_SIZE = 4;
constexpr int LEAF_COLS = 40;  // LEAF_SIZE x (v0 3, e1 3, e2 3, id bits 1)
constexpr int TILE = 256;      // triangles per shared-memory tile of the sweep
// Python rounds these literals from double to float32; so does the kernel
constexpr float DET_EPS = (float)1e-12;
constexpr float DIR_EPS = (float)1e-20;

HD int as_int(float x) {
#ifdef __CUDACC__
  return __float_as_int(x);
#else
  int i;
  memcpy(&i, &x, sizeof i);
  return i;
#endif
}

// four floats at a 16-byte aligned address, through the read-only path
HD void load4(const float* p, float* out) {
#ifdef __CUDACC__
  const float4 v = __ldg(reinterpret_cast<const float4*>(p));
  out[0] = v.x;
  out[1] = v.y;
  out[2] = v.z;
  out[3] = v.w;
#else
  memcpy(out, p, 4 * sizeof(float));
#endif
}

struct RayIn {
  float ox, oy, oz, dx, dy, dz, mint;
};

struct Best {
  float t, u, v;
  int id;
};

// Moller-Trumbore (mesh.cpp:61-97), the component order of
// ops/bvh.py: mt_lanes. tri = v0(3) e1(3) e2(3).
HD bool mt(const RayIn& r, const float* tri, float& t, float& u, float& v) {
  const float v0x = tri[0], v0y = tri[1], v0z = tri[2];
  const float e1x = tri[3], e1y = tri[4], e1z = tri[5];
  const float e2x = tri[6], e2y = tri[7], e2z = tri[8];
  const float px = r.dy * e2z - r.dz * e2y;
  const float py = r.dz * e2x - r.dx * e2z;
  const float pz = r.dx * e2y - r.dy * e2x;
  const float det = e1x * px + e1y * py + e1z * pz;
  const bool det_ok = fabsf(det) > DET_EPS;
  const float inv_det = 1.0f / (det_ok ? det : DET_EPS);
  const float tx = r.ox - v0x, ty = r.oy - v0y, tz = r.oz - v0z;
  u = (tx * px + ty * py + tz * pz) * inv_det;
  const float qx = ty * e1z - tz * e1y;
  const float qy = tz * e1x - tx * e1z;
  const float qz = tx * e1y - ty * e1x;
  v = (r.dx * qx + r.dy * qy + r.dz * qz) * inv_det;
  t = (e2x * qx + e2y * qy + e2z * qz) * inv_det;
  return det_ok && u >= 0.0f && v >= 0.0f && u + v <= 1.0f;
}

// One ray's stackless walk of the packed LBVH (ops/bvh.py: _traverse_walk).
// packed [n_nodes, 8] = min 3 | max 3 | skip bits | first bits;
// leaf [n_leaves, 40]. Counts the nodes visited and the leaves tested.
template <bool ANY>
HD void walk(const float* packed, int n_nodes, const float* leaf, const RayIn& r, Best& b,
             int& visits, int& leaves) {
  const float ix = 1.0f / (fabsf(r.dx) > DIR_EPS ? r.dx : DIR_EPS);
  const float iy = 1.0f / (fabsf(r.dy) > DIR_EPS ? r.dy : DIR_EPS);
  const float iz = 1.0f / (fabsf(r.dz) > DIR_EPS ? r.dz : DIR_EPS);
  int node = 0;
  visits = leaves = 0;
  bool found = false;
  while (node < n_nodes) {
    ++visits;
    float a[4], c[4];
    load4(packed + (size_t)node * 8, a);      // minx miny minz maxx
    load4(packed + (size_t)node * 8 + 4, c);  // maxy maxz skip first
    const int skip = as_int(c[2]), first = as_int(c[3]);
    const float t0x = (a[0] - r.ox) * ix, t1x = (a[3] - r.ox) * ix;
    const float t0y = (a[1] - r.oy) * iy, t1y = (c[0] - r.oy) * iy;
    const float t0z = (a[2] - r.oz) * iz, t1z = (c[1] - r.oz) * iz;
    const float near_ = fmaxf(fmaxf(fminf(t0x, t1x), fminf(t0y, t1y)), fminf(t0z, t1z));
    const float far_ = fminf(fminf(fmaxf(t0x, t1x), fmaxf(t0y, t1y)), fmaxf(t0z, t1z));
    const bool hit_box = near_ <= far_ && far_ >= r.mint && near_ <= b.t;
    if (hit_box && first >= 0) {
      ++leaves;
      float s[LEAF_COLS];
      const float* row = leaf + (size_t)(first / LEAF_SIZE) * LEAF_COLS;
      for (int k = 0; k < LEAF_COLS; k += 4) load4(row + k, s + k);
      for (int j = 0; j < LEAF_SIZE; ++j) {
        const float* slot = s + 10 * j;
        const int pid = as_int(slot[9]);
        float t, u, v;
        if (mt(r, slot, t, u, v) && pid >= 0 && t >= r.mint && t < b.t) {
          b.t = t;
          b.u = u;
          b.v = v;
          b.id = pid;
          found = true;
        }
      }
    }
    node = (hit_box && first < 0) ? node + 1 : skip;
    if (ANY && found) node = n_nodes;
  }
}

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
