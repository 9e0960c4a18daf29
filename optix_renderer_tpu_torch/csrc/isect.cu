// Closest-hit and any-hit kernels of the general path for Hopper (sm_90a).
//
// Replaces three TPU kernels that compute one function, the closest (or any)
// hit of a ray wavefront against the triangle table:
//   * optix_renderer_tpu/ops/pallas/cluster.py:454 cluster_raw -> _cluster_kernel
//     (> 8192 triangles, Morton clusters of 256 swept as bf16 hi/lo matmuls
//     behind an XLA-built worklist)            -> isect_bvh (bvh_kernel<false / true>)
//   * optix_renderer_tpu/ops/pallas/mxu_intersect.py: mxu_raw -> _mxu_kernel
//     (<= 8192 triangles as a [256,16] @ [16,512] matmul)   -> isect_brute
//   * optix_renderer_tpu/ops/pallas/mt_kernel.py: _mt_pallas -> _mt_kernel
//     (brute-force Moller-Trumbore with a fused argmin)     -> isect_brute
// The Pallas kernels take those shapes because Mosaic cannot gather per
// lane. On Hopper each thread owns one ray and walks the LBVH of ops/bvh.py
// with ordinary loads, or sweeps the triangle table in shared-memory tiles.
//
// isect_bvh reads the tree as child pairs (ops/bvh.py: pack_child_pairs):
// one 64-byte row per interior node with both children's boxes and
// references. The skip-link walk of csrc/walk.cuh, one node per step in a
// fixed left-first order, stays with the path kernel's medium branch.
//
// isect_spheres is the same walk, bvh_kernel<ANY, SphLeaf>, over the
// spheres' LBVH of scenes with 65 or more spheres (ops/bvh.py:
// build_sphere_tables): its leaf rows hold four (center, radius, id) slots,
// tested by the stable quadratic. It replaces no Pallas kernel: the JAX
// package walks that tree with an XLA lax.while_loop
// (optix_renderer_tpu/ops/bvh.py:517 traverse_spheres ->
// _traverse_spheres_walk), one gather per node per step for every ray in
// lockstep. Its bound on this card is isect_bvh's (dependent scattered
// loads); a leaf is 80 bytes and 4 x 39 FP32 operations.
//
// What bounds them on this card:
//   * isect_bvh: dependent, scattered loads. A step cannot know its next row
//     before this one has arrived, the few dozen FP32 operations of a step
//     cannot hide an L1/L2 round trip, and a divergent warp's 16-byte gather
//     costs the L1 about one wavefront per distinct line it touches, so the
//     time follows the load instructions per ray (PERF.md §6). The design:
//       - a step reads one pair row as four independent 16-byte __ldg loads,
//         issued together, and slab-tests both children, so a ray reads
//         less than half as many rows as the skip-link walk reads nodes, one
//         round trip each (config A: 1.6 MB of pairs and 4 MB of leaves,
//         L2-resident);
//       - it goes on to the nearer child that was hit and pushes the other
//         with its near t onto a per-ray stack of STACK_DEPTH entries; a
//         closest-hit walk drops popped entries that lie past its best t,
//         so a near hit prunes the far subtrees; an any-hit walk stops at
//         its first confirmed hit;
//       - persistent warps fed from a ray counter: the launch fills the card
//         with blocks (cudaOccupancyMaxActiveBlocksPerMultiprocessor), and a
//         lane whose ray is done takes the next ray index (the lanes without
//         a ray ballot, one of them adds their count to the counter, each
//         takes base + its rank), so a warp does not idle lanes until its
//         slowest ray ends. On an H100 this gave most of the gain over the
//         skip-link walk; a stack in shared memory, the top rows staged in
//         shared memory and rays sorted first did not pay (PERF.md §6).
//   * isect_brute: instruction issue. Without FMA contraction a
//     ray-triangle pair is 27 FMUL and 18 FADD, plus the division and the
//     hit test; the rays move only 48 bytes each, so even at 12 triangles
//     the sweep issues more instructions than its bytes take to arrive
//     (PERF.md §6). The design:
//       - persistent blocks (cudaOccupancyMaxActiveBlocksPerMultiprocessor)
//         that stage a table of up to TILE triangles once in shared memory,
//         as 48-byte rows read by three 16-byte broadcast loads, and take
//         batches of rays by grid stride; a larger table is staged tile by
//         tile;
//       - four consecutive rays per thread, read and written as 16-byte
//         vectors where the arrays are aligned, so a staged row serves four
//         rays;
//       - the division's fast path in line (walk.cuh: rcp_fast) with one
//         warp vote per row for the slow path: `1.0f / x` branches to its
//         slow path after every fast path, which split each ray's
//         arithmetic into its own basic block. With the branch, four rays
//         per thread ran no faster than one (PERF.md §6).
//
// isect_spheres' contract (plain version ops/bvh.py: traverse_spheres_ref,
// the JAX skip-link walk): the same rays in; id [N] int32 (-1 on a miss) and
// t [N] float32 (cutoff on a miss) out. A slot's nearer root in [mint,
// best] is its candidate, else its farther one; it wins with a smaller t, or
// an equal t and a smaller sphere id.
//
// Contract (ops/cuda/isect.py; plain versions ops/bvh.py: traverse_pairs_ref
// and ops/cuda/isect.py: mt_sweep_ref): o, d [N,3], mint, cutoff [N] float32
// in; id [N] int32 (-1 on a miss) and t, u, v [N] float32 out (t = cutoff,
// u = v = 0 on a miss). A hit needs mint <= t < best. The walk breaks exact
// ties in t by the smaller triangle id, so its winner does not depend on the
// visit order; the sweep takes candidates in order with strict <: both give
// a sweep's lowest-index minimum. visits [2, N] (optional) counts the pair
// rows read and the leaves tested per ray. The arithmetic and its order are
// the plain versions', and the library is built without FMA contraction
// (ops/cuda/_build.py), so ids equal theirs.
//
// The per-ray functions are HD: device code under nvcc, plain inline C++
// under a host compiler, so the walk and the sweep can be checked against
// the plain versions without a GPU.
#include "walk.cuh"

namespace isect {

constexpr int TILE = 256;       // triangles a block of the sweep stages at once
constexpr int TRI_COLS = 12;    // a staged row: v0 3, e1 3, e2 3, pad 3
constexpr int BRUTE_THREADS = 128;  // threads per persistent block of the sweep
constexpr int BRUTE_RAYS = 4;   // consecutive rays per thread of the sweep
constexpr int PAIR_COLS = 16;   // left min 3 max 3 | right min 3 max 3 | refs 2 | pad 2
constexpr int STACK_DEPTH = 24; // ops/bvh.py: STACK_DEPTH; deeper trees are refused
constexpr int SPH_LEAF_COLS = 20;  // LEAF_SIZE x (center 3, radius 1, id bits 1)
constexpr float SPH_BIG = 3.4e38f;  // ops/bvh.py: BIG, a slot without a root

// Rows [base, base + cnt) of tri [T, 9] as staged rows of TRI_COLS
// floats: v0 e1 e2 and three pad columns, so that a row is three 16-byte
// loads. k0 / step: this thread's first element and the stride between
// its elements (threadIdx.x / blockDim.x on the card, 0 / 1 on a host).
HD void stage_rows(const float* tri, int base, int cnt, float* tile, int k0, int step) {
  for (int k = k0; k < cnt * 9; k += step)
    tile[(k / 9) * TRI_COLS + k % 9] = tri[(size_t)base * 9 + k];
}

// true where p holds on some active lane of the warp (on a host: p)
HD bool any_lane(bool p) {
#ifdef __CUDA_ARCH__
  return __any_sync(__activemask(), p);
#else
  return p;
#endif
}

// BRUTE_RAYS rays against `cnt` rows staged in shared memory whose first
// triangle has global index `base` (ops/cuda/isect.py: mt_sweep_ref): each
// row is read once and tested against all the rays; each ray takes the rows
// in ascending order with strict <, so it keeps the lowest-index minimum.
// The divisions take rcp_fast, without a branch; a row is divided again
// with `1.0f / x` only where a lane's divisor fails rcp_in_range (one vote
// per row), so t, u and v are mt's.
HD void sweep_rays(const float* tile, int base, int cnt, const RayIn* r, Best* b) {
  constexpr int R = BRUTE_RAYS;
  for (int j = 0; j < cnt; ++j) {
    float tri[TRI_COLS];
    for (int k = 0; k < TRI_COLS; k += 4)
      load4<true>(tile + (size_t)TRI_COLS * j + k, tri + k);
    MtNum m[R];
    float inv[R];
    bool slow = false;
#pragma unroll
    for (int q = 0; q < R; ++q) {
      m[q] = mt_num(r[q], tri);
      inv[q] = rcp_fast(mt_divisor(m[q]));
      slow |= !rcp_in_range(mt_divisor(m[q]));
    }
    if (any_lane(slow)) {
#pragma unroll
      for (int q = 0; q < R; ++q) inv[q] = 1.0f / mt_divisor(m[q]);
    }
#pragma unroll
    for (int q = 0; q < R; ++q) {
      float t, u, v;
      if (mt_hit(m[q], inv[q], t, u, v) && t >= r[q].mint && t < b[q].t)
        b[q] = Best{t, u, v, base + j};
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

// One ray's walk of the child-pair table (ops/bvh.py: traverse_pairs_ref).
// cur: the pair row to read next (>= 0) or the leaf row to test (~cur).
// Its stack, the farther children not yet entered with their near t, is
// kept apart (Stack): with the arrays inside this struct the walk ran 14 %
// slower on an H100 (PERF.md §6).
struct PairWalk {
  RayIn r;
  float ix, iy, iz;
  Best b;
  int cur, sp, rows, leaves;
  bool found;
};

struct Stack {
  int ref[STACK_DEPTH];
  float near_t[STACK_DEPTH];
};

HD void pair_begin(PairWalk& w, const RayIn& r, float cutoff) {
  w.r = r;
  w.ix = 1.0f / (fabsf(r.dx) > DIR_EPS ? r.dx : DIR_EPS);
  w.iy = 1.0f / (fabsf(r.dy) > DIR_EPS ? r.dy : DIR_EPS);
  w.iz = 1.0f / (fabsf(r.dz) > DIR_EPS ? r.dz : DIR_EPS);
  w.b = Best{cutoff, 0.0f, 0.0f, -1};
  w.cur = w.sp = w.rows = w.leaves = 0;
  w.found = false;
}

// the slab test of walk.cuh on one child's box; near_ is its entry t
HD bool child_hit(const PairWalk& w, float x0, float y0, float z0, float x1, float y1, float z1,
                  float& near_) {
  const float t0x = (x0 - w.r.ox) * w.ix, t1x = (x1 - w.r.ox) * w.ix;
  const float t0y = (y0 - w.r.oy) * w.iy, t1y = (y1 - w.r.oy) * w.iy;
  const float t0z = (z0 - w.r.oz) * w.iz, t1z = (z1 - w.r.oz) * w.iz;
  near_ = fmaxf(fmaxf(fminf(t0x, t1x), fminf(t0y, t1y)), fminf(t0z, t1z));
  const float far_ = fminf(fminf(fmaxf(t0x, t1x), fmaxf(t0y, t1y)), fmaxf(t0z, t1z));
  return near_ <= far_ && far_ >= w.r.mint && near_ <= w.b.t;
}

// a leaf row's four triangle slots in order; an equal t goes to the smaller id
HD void test_leaf(const float* leaf, int row_i, PairWalk& w) {
  float s[LEAF_COLS];
  const float* row = leaf + (size_t)row_i * LEAF_COLS;
  for (int k = 0; k < LEAF_COLS; k += 4) load4(row + k, s + k);
  for (int j = 0; j < LEAF_SIZE; ++j) {
    const float* slot = s + 10 * j;
    const int pid = as_int(slot[9]);
    float t, u, v;
    if (mt(w.r, slot, t, u, v) && pid >= 0 && t >= w.r.mint &&
        (t < w.b.t || (t == w.b.t && pid < w.b.id))) {
      w.b = Best{t, u, v, pid};
      w.found = true;
    }
  }
}

// The stable quadratic of ops/bvh.py: sphere_roots, its sums taken
// component by component in that order: the near and far roots of the ray
// against the sphere s = center(3), radius, and whether the discriminant is
// >= 0.
HD bool sphere_roots(const RayIn& r, const float* s, float& tn, float& tf) {
  const float ocx = r.ox - s[0], ocy = r.oy - s[1], ocz = r.oz - s[2];
  const float a = r.dx * r.dx + r.dy * r.dy + r.dz * r.dz;
  const float b = 2.0f * (ocx * r.dx + ocy * r.dy + ocz * r.dz);
  const float c = (ocx * ocx + ocy * ocy + ocz * ocz) - s[3] * s[3];
  const float disc = b * b - 4.0f * a * c;
  const float sq = sqrtf(fmaxf(disc, 0.0f));
  const float sgn = b > 0.0f ? 1.0f : (b < 0.0f ? -1.0f : 0.0f);
  const float q = -0.5f * (b + sgn * sq);
  const float t0 = q / a;
  const float t1 = c / (fabsf(q) > DIR_EPS ? q : DIR_EPS);
  tn = fminf(t0, t1);
  tf = fmaxf(t0, t1);
  return disc >= 0.0f;
}

// The two leaf kinds of the pair walk: `test` takes a leaf row's slots into
// w.b; UV says whether the walk stores u, v.
struct TriLeaf {
  static constexpr bool UV = true;
  static HD void test(const float* leaf, int row_i, PairWalk& w) { test_leaf(leaf, row_i, w); }
};

// a leaf row's four sphere slots in order: each slot's nearer root in
// [mint, best t], else its farther one (bvh.py:474-494), taken with a
// smaller t or an equal t and a smaller id
struct SphLeaf {
  static constexpr bool UV = false;
  static HD void test(const float* leaf, int row_i, PairWalk& w) {
    float s[SPH_LEAF_COLS];
    const float* row = leaf + (size_t)row_i * SPH_LEAF_COLS;
    for (int k = 0; k < SPH_LEAF_COLS; k += 4) load4(row + k, s + k);
    for (int j = 0; j < LEAF_SIZE; ++j) {
      const float* slot = s + 5 * j;
      const int pid = as_int(slot[4]);
      float tn, tf;
      const bool ok = sphere_roots(w.r, slot, tn, tf);
      const float t = ok && tn >= w.r.mint && tn <= w.b.t   ? tn
                      : ok && tf >= w.r.mint && tf <= w.b.t ? tf
                                                            : SPH_BIG;
      if (pid >= 0 && (t < w.b.t || (t == w.b.t && pid < w.b.id))) {
        w.b = Best{t, 0.0f, 0.0f, pid};
        w.found = true;
      }
    }
  }
};

// One step: read a pair row and go on to the nearer child that was hit,
// pushing the other, or test a leaf; then, if there is no child to go on
// to, pop until an entry lies within the best t. Returns true when the
// ray is done.
template <bool ANY, class LEAF = TriLeaf>
HD bool pair_step(const float* pairs, const float* leaf, PairWalk& w, Stack& st) {
  if (w.cur >= 0) {
    ++w.rows;
    const float* row = pairs + (size_t)w.cur * PAIR_COLS;
    float a[4], c[4], e[4], f[4];
    load4(row, a);       // left: minx miny minz maxx
    load4(row + 4, c);   // left: maxy maxz | right: minx miny
    load4(row + 8, e);   // right: minz maxx maxy maxz
    load4(row + 12, f);  // left ref, right ref, pad
    float nl, nr;
    const bool hl = child_hit(w, a[0], a[1], a[2], a[3], c[0], c[1], nl);
    const bool hr = child_hit(w, c[2], c[3], e[0], e[1], e[2], e[3], nr);
    const int rl = as_int(f[0]), rr = as_int(f[1]);
    if (hl && hr) {
      const bool rfirst = nr < nl;
      st.ref[w.sp] = rfirst ? rl : rr;
      st.near_t[w.sp] = rfirst ? nl : nr;
      ++w.sp;
      w.cur = rfirst ? rr : rl;
      return false;
    }
    if (hl || hr) {
      w.cur = hl ? rl : rr;
      return false;
    }
  } else {
    ++w.leaves;
    LEAF::test(leaf, ~w.cur, w);
    if (ANY && w.found) return true;
  }
  while (w.sp > 0) {
    --w.sp;
    if (!(st.near_t[w.sp] > w.b.t)) {
      w.cur = st.ref[w.sp];
      return false;
    }
  }
  return true;
}

template <bool UV = true>
HD void pair_store(const PairWalk& w, int ray, int n, int* out_id, float* out_t, float* out_u,
                   float* out_v, int* visits) {
  out_id[ray] = w.b.id;
  out_t[ray] = w.b.t;
  if (UV) {
    out_u[ray] = w.b.u;
    out_v[ray] = w.b.v;
  }
  if (visits) {
    visits[ray] = w.rows;
    visits[n + ray] = w.leaves;
  }
}

#ifdef __CUDACC__
constexpr uint32_t FULL = 0xffffffffu;
// threads per persistent block; blocks of 64 and 256 measured no faster on
// an H100 (PERF.md §6)
constexpr int BVH_THREADS = 128;
// lanes that must wait at a leaf before a warp pass steps the leaf tests
// (8 to 16 measured alike on an H100, PERF.md §6)
constexpr int LEAF_BATCH = 12;

// Persistent: every lane keeps a ray while rays remain. A lane whose ray is
// done stores it and takes the next index from the counter (one atomicAdd
// per warp for all such lanes), and the warp leaves when no lane holds a
// ray, so every __ballot_sync sees all 32 lanes. Each pass steps one kind
// of lane: those at a pair row, or, once LEAF_BATCH lanes (or all lanes
// with a ray) wait at a leaf, those. A warp that stepped both kinds in
// every pass ran the 10-load leaf test in nearly every pass; a lane still
// takes its own steps in its own order, so its result and counts are the
// plain version's. LEAF: the triangle leaves of isect_bvh, or the sphere
// leaves of isect_spheres (which stores no u, v).
template <bool ANY, class LEAF>
__global__ void __launch_bounds__(BVH_THREADS)
    bvh_kernel(const float* __restrict__ pairs, const float* __restrict__ leaf,
               const float* __restrict__ o, const float* __restrict__ d,
               const float* __restrict__ mint, const float* __restrict__ cutoff, int n,
               int* __restrict__ out_id, float* __restrict__ out_t, float* __restrict__ out_u,
               float* __restrict__ out_v, int* __restrict__ visits,
               uint32_t* __restrict__ next_ray) {
  const uint32_t lane = threadIdx.x & 31u;
  PairWalk w;
  Stack st;
  int ray = 0;
  bool have = false, more = true;
  for (;;) {
    // the lanes without a ray take the next ones, in lane order
    const uint32_t need = __ballot_sync(FULL, !have && more);
    if (need) {
      const int leader = __ffs(need) - 1;
      uint32_t base = 0;
      if ((int)lane == leader) base = atomicAdd(next_ray, (uint32_t)__popc(need));
      base = __shfl_sync(FULL, base, leader);
      if (!have && more) {
        const uint32_t k = base + (uint32_t)__popc(need & ((1u << lane) - 1u));
        if (k < (uint32_t)n) {
          ray = (int)k;
          pair_begin(w, ray_at(o, d, mint, ray), cutoff[ray]);
          have = true;
        } else {
          more = false;  // the counter only grows: no ray is left
        }
      }
    }
    if (!__any_sync(FULL, have)) break;
    const uint32_t at_leaf = __ballot_sync(FULL, have && w.cur < 0);
    const uint32_t at_row = __ballot_sync(FULL, have && w.cur >= 0);
    const bool leaves = __popc(at_leaf) >= LEAF_BATCH || at_row == 0;
    if (have && (w.cur < 0) == leaves && pair_step<ANY, LEAF>(pairs, leaf, w, st)) {
      pair_store<LEAF::UV>(w, ray, n, out_id, out_t, out_u, out_v, visits);
      have = false;
    }
  }
}

// BRUTE_RAYS consecutive rays from i0 on: with VEC (the arrays 16-byte
// aligned) as 16-byte loads, three each of o and d and one each of mint and
// cutoff, all issued before the sweep; else one float at a time. Rays past
// n are zero rays, which no triangle hits, and are not stored.
template <bool VEC>
__device__ __forceinline__ void load_rays(const float* __restrict__ o, const float* __restrict__ d,
                                          const float* __restrict__ mint,
                                          const float* __restrict__ cutoff, int n, int i0,
                                          RayIn* r, Best* b) {
  constexpr int R = BRUTE_RAYS;
  if (VEC && i0 + R <= n) {
    float of[3 * R], df[3 * R], mf[R], cf[R];
    for (int k = 0; k < 3 * R; k += 4) {
      load4(o + 3 * (size_t)i0 + k, of + k);
      load4(d + 3 * (size_t)i0 + k, df + k);
    }
    load4(mint + i0, mf);
    load4(cutoff + i0, cf);
#pragma unroll
    for (int q = 0; q < R; ++q) {
      r[q] = RayIn{of[3 * q], of[3 * q + 1], of[3 * q + 2], df[3 * q], df[3 * q + 1],
                   df[3 * q + 2], mf[q]};
      b[q] = Best{cf[q], 0.0f, 0.0f, -1};
    }
    return;
  }
#pragma unroll
  for (int q = 0; q < R; ++q) {
    const int i = i0 + q;
    r[q] = i < n ? ray_at(o, d, mint, i) : RayIn{};
    b[q] = Best{i < n ? __ldg(cutoff + i) : 0.0f, 0.0f, 0.0f, -1};
  }
}

template <bool VEC>
__device__ __forceinline__ void store_rays(const Best* b, int n, int i0, int* __restrict__ out_id,
                                           float* __restrict__ out_t, float* __restrict__ out_u,
                                           float* __restrict__ out_v) {
  if (VEC && i0 + BRUTE_RAYS <= n) {
    *reinterpret_cast<int4*>(out_id + i0) = make_int4(b[0].id, b[1].id, b[2].id, b[3].id);
    *reinterpret_cast<float4*>(out_t + i0) = make_float4(b[0].t, b[1].t, b[2].t, b[3].t);
    *reinterpret_cast<float4*>(out_u + i0) = make_float4(b[0].u, b[1].u, b[2].u, b[3].u);
    *reinterpret_cast<float4*>(out_v + i0) = make_float4(b[0].v, b[1].v, b[2].v, b[3].v);
    return;
  }
#pragma unroll
  for (int q = 0; q < BRUTE_RAYS; ++q) {
    const int i = i0 + q;
    if (i < n) {
      out_id[i] = b[q].id;
      out_t[i] = b[q].t;
      out_u[i] = b[q].u;
      out_v[i] = b[q].v;
    }
  }
}

// Persistent: the grid fills the card once and each block takes batches of
// BRUTE_THREADS x BRUTE_RAYS rays by grid stride, so every thread of a
// block runs the same batches and may meet at __syncthreads, and every
// lane sweeps (the vote in sweep_rays sees whole warps). A table of up to
// TILE triangles is staged once per block before the first batch; a larger
// one is staged tile by tile in every batch.
template <bool VEC>
__global__ void __launch_bounds__(BRUTE_THREADS)
    brute_kernel(const float* __restrict__ tri, int t_cnt, const float* __restrict__ o,
                 const float* __restrict__ d, const float* __restrict__ mint,
                 const float* __restrict__ cutoff, int n, int* __restrict__ out_id,
                 float* __restrict__ out_t, float* __restrict__ out_u,
                 float* __restrict__ out_v) {
  constexpr int R = BRUTE_RAYS, BATCH = BRUTE_THREADS * BRUTE_RAYS;
  __shared__ __align__(16) float tile[TILE * TRI_COLS];
  const bool resident = t_cnt <= TILE;
  if (resident) {
    stage_rows(tri, 0, t_cnt, tile, threadIdx.x, BRUTE_THREADS);
    __syncthreads();
  }
  const int n_batches = (n + BATCH - 1) / BATCH;
  for (int batch = blockIdx.x; batch < n_batches; batch += gridDim.x) {
    const int i0 = batch * BATCH + threadIdx.x * R;
    RayIn r[R];
    Best b[R];
    load_rays<VEC>(o, d, mint, cutoff, n, i0, r, b);
    if (resident) {
      sweep_rays(tile, 0, t_cnt, r, b);
    } else {
      for (int base = 0; base < t_cnt; base += TILE) {
        const int cnt = min(TILE, t_cnt - base);
        __syncthreads();
        stage_rows(tri, base, cnt, tile, threadIdx.x, BRUTE_THREADS);
        __syncthreads();
        sweep_rays(tile, base, cnt, r, b);
      }
    }
    store_rays<VEC>(b, n, i0, out_id, out_t, out_u, out_v);
  }
}

// rcp_fast against `1.0f / x` on every float x with 2^-126 <= |x| < 2^126,
// bit for bit: counts[0] += the floats tested, counts[1] += those that differ
__global__ void rcp_check_kernel(unsigned long long* counts) {
  unsigned long long tested = 0, differ = 0;
  for (unsigned long long i = blockIdx.x * (unsigned long long)blockDim.x + threadIdx.x;
       i < (1ull << 32); i += (unsigned long long)gridDim.x * blockDim.x) {
    const float x = __uint_as_float((uint32_t)i);
    if (!(fabsf(x) >= 0x1p-126f && fabsf(x) < 0x1p126f)) continue;
    volatile float y = x;  // keeps 1.0f / y the compiler's own division
    ++tested;
    differ += __float_as_uint(1.0f / y) != __float_as_uint(rcp_fast(x));
  }
  atomicAdd(counts, tested);
  atomicAdd(counts + 1, differ);
}
#endif

}  // namespace isect

#ifdef __CUDACC__
namespace {
struct BvhLaunch {
  int blocks, threads, blocks_per_sm;
};
BvhLaunch g_bvh_last = {0, 0, 0};

// persistent blocks: as many as fit on the card at once, at most one per
// BVH_THREADS rays
template <typename K>
cudaError_t launch_bvh(K kernel, const float* pairs, const float* leaf, const float* o,
                       const float* d, const float* mint, const float* cutoff, int n,
                       int* out_id, float* out_t, float* out_u, float* out_v, int* visits,
                       uint32_t* next_ray, cudaStream_t s) {
  const int threads = isect::BVH_THREADS;
  int dev = 0, n_sm = 0, per_sm = 0;
  cudaError_t e = cudaGetDevice(&dev);
  if (e == cudaSuccess) e = cudaDeviceGetAttribute(&n_sm, cudaDevAttrMultiProcessorCount, dev);
  if (e == cudaSuccess) e = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, kernel, threads, 0);
  if (e != cudaSuccess) return e;
  const int need = (n + threads - 1) / threads;
  const int fit = n_sm * (per_sm > 1 ? per_sm : 1);
  const int blocks = need < fit ? need : fit;
  g_bvh_last = BvhLaunch{blocks, threads, per_sm};
  kernel<<<blocks, threads, 0, s>>>(pairs, leaf, o, d, mint, cutoff, n, out_id, out_t, out_u,
                                    out_v, visits, next_ray);
  return cudaSuccess;
}
}  // namespace

// pairs [n_pairs, 16], leaf [n_leaves, 40]; any_hit: 0 closest hit, 1 stop
// at the first confirmed hit; visits [2, n] (pair rows read, leaves tested
// per ray) may be null; next_ray: one uint32 that holds 0 at launch, the
// counter from which the lanes take their rays (a null one is refused).
extern "C" int isect_bvh_launch(const float* pairs, const float* leaf, const float* o,
                                const float* d, const float* mint, const float* cutoff, int n,
                                int any_hit, int* out_id, float* out_t, float* out_u,
                                float* out_v, int* visits, uint32_t* next_ray, void* stream) {
  if (next_ray == nullptr) return (int)cudaErrorInvalidValue;
  cudaStream_t s = (cudaStream_t)stream;
  if (n > 0) {
    const cudaError_t e =
        any_hit ? launch_bvh(isect::bvh_kernel<true, isect::TriLeaf>, pairs, leaf, o, d, mint,
                             cutoff, n, out_id, out_t, out_u, out_v, visits, next_ray, s)
                : launch_bvh(isect::bvh_kernel<false, isect::TriLeaf>, pairs, leaf, o, d, mint,
                             cutoff, n, out_id, out_t, out_u, out_v, visits, next_ray, s);
    if (e != cudaSuccess) return (int)e;
  }
  return (int)cudaGetLastError();
}

// pairs [n_pairs, 16] and leaf [n_leaves, 20] of the spheres' LBVH; as
// isect_bvh_launch, with id and t out (no u, v)
extern "C" int isect_spheres_launch(const float* pairs, const float* leaf, const float* o,
                                    const float* d, const float* mint, const float* cutoff, int n,
                                    int any_hit, int* out_id, float* out_t, int* visits,
                                    uint32_t* next_ray, void* stream) {
  if (next_ray == nullptr) return (int)cudaErrorInvalidValue;
  cudaStream_t s = (cudaStream_t)stream;
  if (n > 0) {
    const cudaError_t e =
        any_hit ? launch_bvh(isect::bvh_kernel<true, isect::SphLeaf>, pairs, leaf, o, d, mint,
                             cutoff, n, out_id, out_t, nullptr, nullptr, visits, next_ray, s)
                : launch_bvh(isect::bvh_kernel<false, isect::SphLeaf>, pairs, leaf, o, d, mint,
                             cutoff, n, out_id, out_t, nullptr, nullptr, visits, next_ray, s);
    if (e != cudaSuccess) return (int)e;
  }
  return (int)cudaGetLastError();
}

// the grid, block size and resident blocks per SM of the last isect_bvh or
// isect_spheres launch
extern "C" void isect_bvh_last_launch(int* blocks, int* threads, int* blocks_per_sm) {
  *blocks = g_bvh_last.blocks;
  *threads = g_bvh_last.threads;
  *blocks_per_sm = g_bvh_last.blocks_per_sm;
}

namespace {
BvhLaunch g_brute_last = {0, 0, 0};

// persistent blocks: as many as fit on the card at once, at most one per
// batch of BRUTE_THREADS x BRUTE_RAYS rays
template <typename K>
cudaError_t launch_brute(K kernel, const float* tri, int t_cnt, const float* o, const float* d,
                         const float* mint, const float* cutoff, int n, int* out_id,
                         float* out_t, float* out_u, float* out_v, cudaStream_t s) {
  const int threads = isect::BRUTE_THREADS, batch = threads * isect::BRUTE_RAYS;
  int dev = 0, n_sm = 0, per_sm = 0;
  cudaError_t e = cudaGetDevice(&dev);
  if (e == cudaSuccess) e = cudaDeviceGetAttribute(&n_sm, cudaDevAttrMultiProcessorCount, dev);
  if (e == cudaSuccess) e = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, kernel, threads, 0);
  if (e != cudaSuccess) return e;
  const int need = (n + batch - 1) / batch;
  const int fit = n_sm * (per_sm > 1 ? per_sm : 1);
  const int blocks = need < fit ? need : fit;
  g_brute_last = BvhLaunch{blocks, threads, per_sm};
  kernel<<<blocks, threads, 0, s>>>(tri, t_cnt, o, d, mint, cutoff, n, out_id, out_t, out_u,
                                    out_v);
  return cudaSuccess;
}
}  // namespace

// tri [t_cnt, 9] = v0 e1 e2 per row; vec: o, d, mint, cutoff and the outputs
// are 16-byte aligned (the wrapper checks), so the rays are read and written
// as 16-byte vectors (a vec launch on unaligned arrays is refused)
extern "C" int isect_brute_launch(const float* tri, int t_cnt, const float* o, const float* d,
                                  const float* mint, const float* cutoff, int n, int vec,
                                  int* out_id, float* out_t, float* out_u, float* out_v,
                                  void* stream) {
  const bool aligned = ((uintptr_t)o | (uintptr_t)d | (uintptr_t)mint | (uintptr_t)cutoff |
                        (uintptr_t)out_id | (uintptr_t)out_t | (uintptr_t)out_u |
                        (uintptr_t)out_v) % 16 == 0;
  if (vec && !aligned) return (int)cudaErrorInvalidValue;
  cudaStream_t s = (cudaStream_t)stream;
  if (n > 0) {
    const cudaError_t e =
        vec ? launch_brute(isect::brute_kernel<true>, tri, t_cnt, o, d, mint, cutoff, n, out_id,
                           out_t, out_u, out_v, s)
            : launch_brute(isect::brute_kernel<false>, tri, t_cnt, o, d, mint, cutoff, n, out_id,
                           out_t, out_u, out_v, s);
    if (e != cudaSuccess) return (int)e;
  }
  return (int)cudaGetLastError();
}

// counts [2] (uint64, zeroed by the caller): the floats rcp_check_kernel
// tested and those where rcp_fast differs from 1.0f / x
extern "C" int isect_rcp_check_launch(unsigned long long* counts, void* stream) {
  int dev = 0, n_sm = 0;
  cudaError_t e = cudaGetDevice(&dev);
  if (e == cudaSuccess) e = cudaDeviceGetAttribute(&n_sm, cudaDevAttrMultiProcessorCount, dev);
  if (e != cudaSuccess) return (int)e;
  isect::rcp_check_kernel<<<n_sm * 8, 256, 0, (cudaStream_t)stream>>>(counts);
  return (int)cudaGetLastError();
}

// the grid, block size and resident blocks per SM of the last isect_brute
// launch
extern "C" void isect_brute_last_launch(int* blocks, int* threads, int* blocks_per_sm) {
  *blocks = g_brute_last.blocks;
  *threads = g_brute_last.threads;
  *blocks_per_sm = g_brute_last.blocks_per_sm;
}
#endif
