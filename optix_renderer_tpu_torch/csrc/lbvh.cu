// The LBVH build on the card, for Hopper (sm_90a).
//
// Replaces optix_renderer_tpu/native/lbvh.cpp:60 lbvh_build (reached from
// ops/bvh.py:160 build_lbvh_host), the JAX package's OpenMP C++ builder,
// which has no Pallas counterpart: the JAX package builds on the host. It
// computes what the numpy builder of this package computes
// (ops/bvh.py: build_lbvh_numpy, the leaf packing and pack_child_pairs),
// bit for bit: triangles (or spheres, as the boxes of (c - r, c + r, c))
// sorted by the 30-bit Morton code of their centroid, LEAF per leaf, a
// median-split tree over the leaves in DFS preorder with skip links, the
// node table `packed` [Nn, 8], the leaf table [n_leaves, 40] (or [.., 20]
// for spheres) and the child-pair table `pairs` [n_pairs, 16].
//
// One chain of simple kernels, three entry points, with two torch.sort
// calls between them (ops/cuda/lbvh.py):
//   lbvh_keys_launch   bounds_kernel: per primitive its box and centroid,
//                      the centroid bounds by order-preserving uint keys
//                      (warp and block min / max, one atomic per block);
//                      keys_kernel: (Morton code << 32) | index.
//   (torch.sort of the keys: unique keys, so the order is
//    np.argsort(kind="stable")'s)
//   lbvh_tree_launch   leaf_kernel: one thread per leaf folds its box in
//                      sorted order, writes its slots of the leaf table
//                      (staged in shared memory, stored coalesced),
//                      then walks down from the root carrying the escape
//                      link and writes skip / first and the pair-order key
//                      (level << 32) | node of each node whose leaf range
//                      starts at its leaf, so every node is written once;
//                      box_kernel, once per level from the deepest interior
//                      level up: each interior node's box from its children.
//   (torch.sort of the pair-order keys (level << 32) | node: the
//    breadth-first rows of pack_child_pairs)
//   lbvh_pairs_launch  rowof_kernel: the pair row of each interior node;
//                      pairs_kernel: one row per interior node (staged in
//                      shared memory, stored coalesced).
//
// numpy's tie rule everywhere: np.minimum(a, b) is a < b ? a : b and
// np.maximum(a, b) is a > b ? a : b (a tie between +0 and -0 keeps the
// second operand; fminf / fmaxf and std::min do not follow it), in the
// operand order of the numpy builder: the corners (v0, v1) then v2, the
// leaf fold acc = min(acc, x) in sorted order from +-inf (np.minimum.at),
// the interior fold min(left, right). The Morton quotient is an IEEE
// division (no fast math, -fmad=false). The sign of zero of the centroid
// bounds cannot change a code: c - lo and hi - lo are then equal or +-0,
// and +-0 clamps to code 0.
//
// What bounds it on this card: bytes. The function reads 36 B per triangle
// (16 per sphere) and writes 72 (the leaf table 40, packed 16, pairs 16):
// 0.13 ms at 4M triangles at 3.35 TB/s, with a few tens of FP32 operations
// per primitive. The chain moves far more: the keys through two radix
// sorts, each primitive gathered twice in sorted (Morton) order, which is
// random in memory, one box pass per level over every node. The design
// stages the leaf and pair rows in shared memory so that their stores
// coalesce, and does nothing else about it yet: a hand-written sort, one
// fused pass per level range, or primitives permuted once into sorted
// order are later work.
//
// The per-thread bodies are HD functions over plain pointers, so they also
// compile with a host compiler for rehearsal.

#include <stdint.h>
#include <string.h>

#ifdef __CUDACC__
#include <cuda_runtime.h>
#define HD __device__ __forceinline__
#else
#define HD inline
#endif

namespace lbvh {

constexpr int LEAF = 4;         // ops/bvh.py LEAF_SIZE
constexpr int NODE_COLS = 8;    // min(3) max(3) skip bits, first bits
constexpr int PAIR_COLS = 16;   // ops/bvh.py PAIR_COLS
constexpr int THREADS = 256;
constexpr long long LEAF_KEY = 0x7fffffffffffffffLL;  // sorts after every interior node

HD float min_np(float a, float b) { return a < b ? a : b; }
HD float max_np(float a, float b) { return a > b ? a : b; }
HD uint32_t f2u(float f) { uint32_t u; memcpy(&u, &f, 4); return u; }
HD float u2f(uint32_t u) { float f; memcpy(&f, &u, 4); return f; }

// a float as a uint whose unsigned order is the float order (-0 below +0)
HD uint32_t order_key(float f) {
  const uint32_t u = f2u(f);
  return (u & 0x80000000u) ? ~u : (u | 0x80000000u);
}
HD float order_val(uint32_t k) { return u2f((k & 0x80000000u) ? (k & 0x7fffffffu) : ~k); }

HD uint32_t expand_bits(uint32_t v) {
  v = (v * 0x00010001u) & 0xFF0000FFu;
  v = (v * 0x00000101u) & 0x0F00F00Fu;
  v = (v * 0x00000011u) & 0xC30C30C3u;
  v = (v * 0x00000005u) & 0x49249249u;
  return v;
}

// np.clip(p * 1024, 0, 1023).astype(uint32)
HD uint32_t quantize(float p) {
  float c = p * 1024.0f;
  c = c < 0.0f ? 0.0f : c;
  c = c > 1023.0f ? 1023.0f : c;
  return (uint32_t)c;
}

// primitive i's box: tmin = minimum(minimum(v0, v1), v2), tmax likewise
HD void prim_box(const float* v0, const float* v1, const float* v2, long long i, float* mn,
                 float* mx) {
  for (int k = 0; k < 3; ++k) {
    const float a = v0[i * 3 + k], b = v1[i * 3 + k], c = v2[i * 3 + k];
    mn[k] = min_np(min_np(a, b), c);
    mx[k] = max_np(max_np(a, b), c);
  }
}

HD void centroid(const float* v0, const float* v1, const float* v2, long long i, float* c) {
  float mn[3], mx[3];
  prim_box(v0, v1, v2, i, mn, mx);
  for (int k = 0; k < 3; ++k) c[k] = 0.5f * (mn[k] + mx[k]);
}

// bounds: 6 order keys, lo(3) then hi(3)
HD long long morton_key(const float* cent, const uint32_t* bounds, long long i) {
  uint32_t q[3];
  for (int k = 0; k < 3; ++k) {
    const float lo = order_val(bounds[k]), hi = order_val(bounds[3 + k]);
    const float ext = max_np(hi - lo, 1e-12f);
    q[k] = quantize((cent[i * 3 + k] - lo) / ext);
  }
  const uint32_t code = (expand_bits(q[0]) << 2) | (expand_bits(q[1]) << 1) | expand_bits(q[2]);
  return (long long)(((uint64_t)code << 32) | (uint64_t)i);
}

struct Tree {
  const float* v0;
  const float* v1;
  const float* v2;
  const float* radius;  // spheres: [n] radii, v2 the centres; null for triangles
  long long n;
  int n_leaves;
  const long long* sorted;  // [n] keys, ascending: the low 32 bits are primitive ids
  float* packed;            // [2 n_leaves - 1, 8]
  float* leaf;              // [n_leaves, LEAF * 10] (triangles) or [.., LEAF * 5]
  long long* pkey;          // [2 n_leaves - 1] (level << 32) | node, LEAF_KEY for a leaf node
};

HD void put_links(const Tree& t, int node, int skip, int first, int lev) {
  t.packed[(long long)node * NODE_COLS + 6] = u2f((uint32_t)skip);
  t.packed[(long long)node * NODE_COLS + 7] = u2f((uint32_t)first);
  t.pkey[node] = first >= 0 ? LEAF_KEY : (long long)(((uint64_t)lev << 32) | (uint32_t)node);
}

HD int leaf_cols(const Tree& t) { return t.radius == nullptr ? LEAF * 10 : LEAF * 5; }

// leaf l: its slots into `row` (its row of the leaf table, leaf_cols
// floats) and its box, then its path from the root
HD void leaf_body(const Tree& t, int l, float* row) {
  const float inf = u2f(0x7f800000u);
  float bmin[3] = {inf, inf, inf}, bmax[3] = {-inf, -inf, -inf};
  for (int s = 0; s < LEAF; ++s) {
    const long long i = (long long)l * LEAF + s;
    const int id = i < t.n ? (int)(uint32_t)(t.sorted[i] & 0xffffffffLL) : -1;
    const long long g = id < 0 ? 0 : id;  // pad slots read primitive 0, as gid = max(id, 0)
    if (id >= 0) {
      float mn[3], mx[3];
      prim_box(t.v0, t.v1, t.v2, g, mn, mx);
      for (int k = 0; k < 3; ++k) {
        bmin[k] = min_np(bmin[k], mn[k]);
        bmax[k] = max_np(bmax[k], mx[k]);
      }
    }
    if (t.radius == nullptr) {
      float* slot = row + s * 10;
      for (int k = 0; k < 3; ++k) {
        const float a = t.v0[g * 3 + k];
        slot[k] = a;
        slot[3 + k] = id >= 0 ? t.v1[g * 3 + k] - a : 0.0f;
        slot[6 + k] = id >= 0 ? t.v2[g * 3 + k] - a : 0.0f;
      }
      slot[9] = u2f((uint32_t)id);
    } else {
      float* slot = row + s * 5;
      for (int k = 0; k < 3; ++k) slot[k] = t.v2[g * 3 + k];
      slot[3] = id >= 0 ? t.radius[g] : 0.0f;
      slot[4] = u2f((uint32_t)id);
    }
  }
  // down from the root: node `idx` over leaves [lo, hi), escape link `esc`
  const int n_nodes = 2 * t.n_leaves - 1;
  int idx = 0, lo = 0, hi = t.n_leaves, esc = n_nodes, lev = 0;
  while (hi - lo > 1) {
    const int mid = lo + (hi - lo) / 2;
    if (lo == l) put_links(t, idx, esc, -1, lev);
    const int li = idx + 1, ri = idx + 2 * (mid - lo);
    if (l < mid) {  // the left child escapes to the right child
      esc = ri;
      idx = li;
      hi = mid;
    } else {  // the right child inherits the parent's escape
      idx = ri;
      lo = mid;
    }
    ++lev;
  }
  put_links(t, idx, esc, l * LEAF, lev);
  float* box = t.packed + (long long)idx * NODE_COLS;
  for (int k = 0; k < 3; ++k) {
    box[k] = bmin[k];
    box[3 + k] = bmax[k];
  }
}

HD int link(const float* packed, long long node, int col) {
  return (int)f2u(packed[node * NODE_COLS + col]);
}

// interior node i of level lev: its box from its children (left, right)
HD void box_body(float* packed, const long long* pkey, int i, int lev) {
  if (pkey[i] == LEAF_KEY || (pkey[i] >> 32) != lev) return;
  const long long li = i + 1, ri = link(packed, li, 6);
  float* p = packed + (long long)i * NODE_COLS;
  const float* a = packed + li * NODE_COLS;
  const float* b = packed + ri * NODE_COLS;
  for (int k = 0; k < 3; ++k) {
    p[k] = min_np(a[k], b[k]);
    p[3 + k] = max_np(a[3 + k], b[3 + k]);
  }
}

HD int pair_ref(const float* packed, const int* row_of, long long child) {
  const int first = link(packed, child, 7);
  return first >= 0 ? ~(first / LEAF) : row_of[child];
}

// the pair row of interior node `node` into `row` (PAIR_COLS floats): both
// children's boxes and references
HD void pair_body(const float* packed, const int* row_of, int node, float* row) {
  const long long kids[2] = {node + 1LL, (long long)link(packed, node + 1LL, 6)};
  for (int side = 0; side < 2; ++side) {
    for (int k = 0; k < 6; ++k) row[6 * side + k] = packed[kids[side] * NODE_COLS + k];
    row[12 + side] = u2f((uint32_t)pair_ref(packed, row_of, kids[side]));
  }
  row[14] = 0.0f;
  row[15] = 0.0f;
}

// the one row of a tree whose root is a leaf: that leaf on the left, an
// empty right slot (numpy's NaN, 0x7fc00000, which no slab test hits, ref ~0)
HD void root_leaf_row(const float* packed, float* pairs) {
  for (int k = 0; k < 6; ++k) pairs[k] = packed[k];
  for (int k = 6; k < 12; ++k) pairs[k] = u2f(0x7fc00000u);
  pairs[12] = u2f((uint32_t)~(link(packed, 0, 7) / LEAF));
  pairs[13] = u2f((uint32_t)~0);
  pairs[14] = 0.0f;
  pairs[15] = 0.0f;
}

#ifdef __CUDACC__

__global__ void bounds_kernel(const float* v0, const float* v1, const float* v2, long long n,
                              float* cent, uint32_t* bounds) {
  const long long i = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  uint32_t key[6] = {0xffffffffu, 0xffffffffu, 0xffffffffu, 0u, 0u, 0u};
  if (i < n) {
    float c[3];
    centroid(v0, v1, v2, i, c);
    for (int k = 0; k < 3; ++k) {
      cent[i * 3 + k] = c[k];
      key[k] = key[3 + k] = order_key(c[k]);
    }
  }
  for (int off = 16; off > 0; off >>= 1)
    for (int k = 0; k < 3; ++k) {
      key[k] = min(key[k], __shfl_xor_sync(0xffffffffu, key[k], off));
      key[3 + k] = max(key[3 + k], __shfl_xor_sync(0xffffffffu, key[3 + k], off));
    }
  __shared__ uint32_t warp_keys[THREADS / 32][6];
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  if (lane == 0)
    for (int k = 0; k < 6; ++k) warp_keys[warp][k] = key[k];
  __syncthreads();
  if (threadIdx.x < 6) {
    const int k = threadIdx.x;
    uint32_t v = warp_keys[0][k];
    for (int w = 1; w < THREADS / 32; ++w)
      v = k < 3 ? min(v, warp_keys[w][k]) : max(v, warp_keys[w][k]);
    if (k < 3)
      atomicMin(&bounds[k], v);
    else
      atomicMax(&bounds[k], v);
  }
}

__global__ void keys_kernel(const float* cent, const uint32_t* bounds, long long n,
                            long long* keys) {
  const long long i = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  if (i < n) keys[i] = morton_key(cent, bounds, i);
}

// one thread per leaf; the block's rows of the leaf table are staged in
// shared memory (THREADS x 160 B at most) and stored contiguously, so the
// stores coalesce (one thread's 160-byte row would not)
__global__ void leaf_kernel(Tree t) {
  extern __shared__ float rows[];
  const int cols = leaf_cols(t);
  const int l0 = blockIdx.x * blockDim.x;
  if (l0 + (int)threadIdx.x < t.n_leaves) leaf_body(t, l0 + threadIdx.x, rows + threadIdx.x * cols);
  __syncthreads();
  const int n_vals = min((int)blockDim.x, t.n_leaves - l0) * cols;
  float* out = t.leaf + (long long)l0 * cols;
  for (int k = threadIdx.x; k < n_vals; k += blockDim.x) out[k] = rows[k];
}

__global__ void box_kernel(float* packed, const long long* pkey, int n_nodes, int lev) {
  const int i = blockIdx.x * blockDim.x + threadIdx.x;
  if (i < n_nodes) box_body(packed, pkey, i, lev);
}

__global__ void rowof_kernel(const long long* order, int n_pairs, int* row_of) {
  const int r = blockIdx.x * blockDim.x + threadIdx.x;
  if (r < n_pairs) row_of[order[r] & 0xffffffffLL] = r;
}

// one thread per pair row, the block's rows staged in shared memory and
// stored contiguously, as leaf_kernel's
__global__ void pairs_kernel(const float* packed, const long long* order, const int* row_of,
                             int n_pairs, int n_leaves, float* pairs) {
  __shared__ float rows[THREADS * PAIR_COLS];
  const int r0 = blockIdx.x * blockDim.x, r = r0 + threadIdx.x;
  if (n_leaves == 1) {
    if (r == 0) root_leaf_row(packed, pairs);
    return;
  }
  if (r < n_pairs)
    pair_body(packed, row_of, (int)(order[r] & 0xffffffffLL), rows + threadIdx.x * PAIR_COLS);
  __syncthreads();
  const int n_vals = min((int)blockDim.x, n_pairs - r0) * PAIR_COLS;
  float* out = pairs + (long long)r0 * PAIR_COLS;
  for (int k = threadIdx.x; k < n_vals; k += blockDim.x) out[k] = rows[k];
}

inline int blocks_for(long long n) { return (int)((n + THREADS - 1) / THREADS); }

#endif  // __CUDACC__

}  // namespace lbvh

#ifdef __CUDACC__

// v0, v1, v2 [n, 3] float32: the corners (spheres: c - r, c + r, c).
// cent [n, 3] float32 and bounds (6 uint32) are scratch; keys [n] int64
// receives (Morton code << 32) | index. Returns a cudaError_t code.
extern "C" int lbvh_keys_launch(const float* v0, const float* v1, const float* v2, long long n,
                                float* cent, uint32_t* bounds, long long* keys, void* stream) {
  if (n <= 0 || n >= (1LL << 31) - lbvh::LEAF) return (int)cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  // the bounds start at the identities of min (all ones) and max (zero)
  cudaError_t e = cudaMemsetAsync(bounds, 0xff, 3 * sizeof(uint32_t), s);
  if (e == cudaSuccess) e = cudaMemsetAsync(bounds + 3, 0, 3 * sizeof(uint32_t), s);
  if (e != cudaSuccess) return (int)e;
  const int blocks = lbvh::blocks_for(n);
  lbvh::bounds_kernel<<<blocks, lbvh::THREADS, 0, s>>>(v0, v1, v2, n, cent, bounds);
  e = cudaGetLastError();
  if (e != cudaSuccess) return (int)e;
  lbvh::keys_kernel<<<blocks, lbvh::THREADS, 0, s>>>(cent, bounds, n, keys);
  return (int)cudaGetLastError();
}

// sorted [n] int64: the keys in ascending order. radius: null for
// triangles (leaf [n_leaves, 40]) or the spheres' radii, with v2 their
// centres (leaf [n_leaves, 20]). Writes packed [2 n_leaves - 1, 8] and
// pkey [2 n_leaves - 1], the pair-order keys; n_levels: the tree's levels
// (ops/bvh.py: lbvh_depth), so the box pass runs once per interior level.
extern "C" int lbvh_tree_launch(const float* v0, const float* v1, const float* v2,
                                const float* radius, long long n, const long long* sorted,
                                float* packed, float* leaf, long long* pkey, int n_levels,
                                void* stream) {
  const long long n_leaves = (n + lbvh::LEAF - 1) / lbvh::LEAF;
  if (n <= 0 || n >= (1LL << 31) - lbvh::LEAF) return (int)cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const lbvh::Tree t{v0, v1, v2, radius, n, (int)n_leaves, sorted, packed, leaf, pkey};
  const int cols = radius == nullptr ? lbvh::LEAF * 10 : lbvh::LEAF * 5;  // leaf_cols
  lbvh::leaf_kernel<<<lbvh::blocks_for(n_leaves), lbvh::THREADS,
                      lbvh::THREADS * cols * sizeof(float), s>>>(t);
  cudaError_t e = cudaGetLastError();
  if (e != cudaSuccess) return (int)e;
  const int n_nodes = (int)(2 * n_leaves - 1);
  for (int lev = n_levels - 2; lev >= 0; --lev) {  // interior levels, deepest first
    lbvh::box_kernel<<<lbvh::blocks_for(n_nodes), lbvh::THREADS, 0, s>>>(packed, pkey, n_nodes,
                                                                         lev);
    e = cudaGetLastError();
    if (e != cudaSuccess) return (int)e;
  }
  return (int)cudaSuccess;
}

// order [>= n_pairs] int64: the pair-order keys in ascending order (unread
// when n_leaves is 1); row_of [2 n_leaves - 1] int32 scratch; pairs
// [n_pairs, 16], n_pairs = max(n_leaves - 1, 1).
extern "C" int lbvh_pairs_launch(const float* packed, const long long* order, int* row_of,
                                 int n_leaves, float* pairs, void* stream) {
  if (n_leaves <= 0) return (int)cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const int n_pairs = n_leaves > 1 ? n_leaves - 1 : 1;
  if (n_leaves > 1) {
    lbvh::rowof_kernel<<<lbvh::blocks_for(n_pairs), lbvh::THREADS, 0, s>>>(order, n_pairs,
                                                                           row_of);
    const cudaError_t e = cudaGetLastError();
    if (e != cudaSuccess) return (int)e;
  }
  lbvh::pairs_kernel<<<lbvh::blocks_for(n_pairs), lbvh::THREADS, 0, s>>>(packed, order, row_of,
                                                                         n_pairs, n_leaves,
                                                                         pairs);
  return (int)cudaGetLastError();
}

#endif  // __CUDACC__
