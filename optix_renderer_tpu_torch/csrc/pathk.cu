// Regenerating path-trace kernel for Hopper (sm_90a): each pixel is traced
// whole, in sample order, by one thread.
//
// Replaces both branches of the TPU kernel
// optix_renderer_tpu/ops/pallas/pathk.py: pathk_trace -> _pathk_kernel:
// pathk_kernel<MIS> the small-scene (<= 64 triangles) VPU branch,
// pathk_staged_kernel<MIS> the medium (65-8,192 triangles) MXU branch
// (mega.closest_hit + the exact per-winner refine, occluded_mxu,
// mega.nee_sample). The TPU kernel works on [8, 512] pixel blocks with SMEM
// scalar packs, select-loops and, in the MXU branch, Moller-Trumbore as a
// [4*256,16]@[16,512] matmul with one-hot attribute fetches, because Mosaic
// cannot gather per lane; here a thread runs a pixel's loop of regenerating
// bounces (bounce(), one iteration with the carried state of the TPU
// kernel's `body`, shared by both branches), reading the scene tables
// through ordinary loads.
//
// How a bounce finds its hits. The small branch sweeps v0|e1|e2 of the
// [T, 48] triangle rows in triangle order, the closest hit and the pending
// shadow ray's any hit in one pass (strict < against the running best: the
// lowest-index minimum). The medium branch walks the scene's LBVH instead
// (csrc/walk.cuh, the walk of isect_bvh): a closest-hit walk that breaks
// exact ties in t by the smaller id, so its winner is the sweep's, then an
// any-hit walk of the shadow segment when one is pending. Both read the
// winner's [T, 48] row once per bounce, and the branches also differ in
// NEE's emissive-triangle pick (nee_sample<MEDIUM>).
//
// What bounds it on the card. Neither branch moves much memory (16 floats
// out per pixel) or uses the tensor cores. The small branch: the latency of
// its FP32 and transcendental work (Moller-Trumbore over every triangle
// twice per bounce, BSDF and NEE math, camera rays) and lanes that wait on
// their warp's slowest pixel: path lengths vary with Russian roulette (16
// to 142 iterations per pixel at 16 spp in the Cornell box), so a warp of
// 32 fixed pixels keeps 0.768 of its lanes busy. So pathk_kernel runs
// persistent blocks whose lanes refill: a lane whose pixel is done takes
// the next one from a counter, and the warp's lanes stay busy until the
// pixels run out; the scene's tables sit in shared memory (20 % faster on
// an H100 than one thread per pixel in a fixed grid, PERF.md). The medium
// branch: the walks' dependent loads (one 32-byte node, then for a leaf
// whose box is hit one 160-byte leaf row, before the next step is known)
// and the divergence of incoherent bounce rays. So pathk_staged_kernel
// keeps the node table (at most 4,095 nodes, 131 KB) in shared memory,
// copied once per block by a TMA bulk copy, leaves the leaves on __ldg,
// runs one persistent 512-thread block per SM (128 registers: the occupancy
// that 128 registers allow anyway), and hands out pixels 32 at a time per
// warp from a counter, so no SM idles while pixels remain (27 % faster on
// an H100 than one thread per pixel with the nodes on __ldg, PERF.md).
// Built without FMA contraction (ops/cuda/_build.py), so the rows equal the
// plain torch version's bit for bit, whichever thread runs a pixel.
//
// Contract (same as ops/cuda/pathk.py: pathk_trace_ref):
//   out [16, n_pix] float32: column c holds pixel pix0 + c, the range
//   [pix0, pix0 + n_pix) of the image (the JAX kernel's base_block; a
//   range traced alone gives the columns of one launch over the image bit
//   for bit); rows 0:3 sum L, 3 samples done, 4:7 sum albedo, 7:10 sum
//   normal, 10 loop iterations of this pixel, 11:16 zero.
// A pixel leaves its loop only when it has no active path and no pending
// shadow ray, or after n_spp * max_depth + 2 iterations. pcg32 draws follow
// the TPU kernel's order: seed tea(pix, (spp0 + k) ^ seed), jitter 2 +
// aperture 2, RR 1, NEE pick 1 + 3 (MIS only), BSDF 2.
#include "mega.cuh"
#include "walk.cuh"

#ifdef __CUDACC__
#include <cuda_runtime.h>
#endif

namespace pk {

// above this many triangles, the medium branch (the TPU kernel's MXU branch)
constexpr int VPU_MAX_TRIS = 64;

struct Tables {
  const float* sf;   // [40] camera pack
  const float* em;   // [n_emitters, 24]
  const float* env;  // [4] constant env radiance + presence flag
  const float* sph;  // [n_sph_rows, 32]
  const float* tri;  // [t_cnt, 48]
  const float* et;   // [te_pad, 24] emissive triangles, te_cnt of them real
  const float* nodes;  // [n_nodes, 8] packed LBVH (medium branch)
  const float* leaf;   // [n_leaves, 40] its leaves: v0 | e1 | e2 | id per slot
  int n_sph_rows, t_cnt, te_cnt, te_pad, n_emitters, n_nodes;
  // pdf_env: 1 / (4 pi n_lights), the MIS pdf of a constant envmap
  float n_lights, pdf_env;
  int n_pix, width, n_spp, max_depth, rfilter, use_dof;
  uint32_t pix0, spp0, seed;  // pix0: the image pixel of out's column 0
};

struct Ray {
  V3 o, d;
  float mint, maxt;
};

// filter importance sampling: (u1, u2) -> jitter distributed as the filter
HD void fis_jitter2(float u1, float u2, int rfilter, float& jx, float& jy) {
  if (rfilter == 0) {  // box
    jx = u1;
    jy = u2;
  } else if (rfilter == 1) {  // tent: inverse CDF of (1 - |x|)
    float u[2] = {u1, u2}, j[2];
    for (int k = 0; k < 2; ++k) {
      float lo = sqrtf(fmaxf(2.0f * u[k], 0.0f)) - 1.0f;
      float hi = 1.0f - sqrtf(fmaxf(2.0f - 2.0f * u[k], 0.0f));
      j[k] = (u[k] < 0.5f ? lo : hi) + 0.5f;
    }
    jx = j[0];
    jy = j[1];
  } else {  // gaussian: Box-Muller at sigma 0.5, clamped to radius 2
    float r = 0.5f * sqrtf(-2.0f * logf(fmaxf(1.0f - u1, 1e-12f)));
    float th = TWO_PI * u2;
    jx = clampf(r * cosf(th), -2.0f, 2.0f) + 0.5f;
    jy = clampf(r * sinf(th), -2.0f, 2.0f) + 0.5f;
  }
}

// seed the pixel's stream for sample k and make its camera ray
HD Ray camera_ray(const Tables& T, uint32_t pix, float px, float py, uint32_t k, Pcg32& st) {
  st = pcg32_seed((uint64_t)tea4(pix, (T.spp0 + k) ^ T.seed), (uint64_t)pix);
  const float* sf = T.sf;
  float uj1 = draw1(st), uj2 = draw1(st);
  float jx, jy;
  fis_jitter2(uj1, uj2, T.rfilter, jx, jy);
  float a1 = draw1(st), a2 = draw1(st);
  float x = (px + jx) * sf[36];
  float y = (py + jy) * sf[37];
  float nx = sf[0] * x + sf[1] * y + sf[3];
  float ny = sf[4] * x + sf[5] * y + sf[7];
  float nz = sf[8] * x + sf[9] * y + sf[11];
  float wq = sf[12] * x + sf[13] * y + sf[15];
  float inv_w = 1.0f / wq;
  V3 dl = vnormalize(V3{nx * inv_w, ny * inv_w, nz * inv_w});
  V3 o_cam{0.0f, 0.0f, 0.0f}, d_cam = dl;
  if (T.use_dof) {
    float r = sf[32] * sqrtf(fmaxf(a1, 0.0f));
    float th = TWO_PI * a2;
    V3 p_lens{r * cosf(th), r * sinf(th), 0.0f};
    float ft = sf[33] / dl.z;
    d_cam = vnormalize(vsub(vscale(dl, ft), p_lens));
    o_cam = p_lens;
  }
  const float* tm = sf + 16;
  Ray ray;
  ray.o = V3{tm[0] * o_cam.x + tm[1] * o_cam.y + tm[2] * o_cam.z + tm[3],
             tm[4] * o_cam.x + tm[5] * o_cam.y + tm[6] * o_cam.z + tm[7],
             tm[8] * o_cam.x + tm[9] * o_cam.y + tm[10] * o_cam.z + tm[11]};
  ray.d = V3{tm[0] * d_cam.x + tm[1] * d_cam.y + tm[2] * d_cam.z,
             tm[4] * d_cam.x + tm[5] * d_cam.y + tm[6] * d_cam.z,
             tm[8] * d_cam.x + tm[9] * d_cam.y + tm[10] * d_cam.z};
  float inv_z = 1.0f / dl.z;
  ray.mint = sf[34] * inv_z;
  ray.maxt = sf[35] * inv_z;
  return ray;
}

struct Nee {
  V3 wi, value;
  float pdf_sa, shadow_dist;
};

// NEE sample (path_mis.cpp:74-106 EMS side): emitter pick, emissive triangle
// by its area CDF (dpdf sampleReuse), then area / point / spot / directional /
// constant-env sampling. Draws pick 1 + 3. MEDIUM takes mega.nee_sample's
// pick (mega.py:909-925): the first of all te_pad rows that qualifies, else
// row te_pad - 1, so the area sample's validity has no `found` term.
template <bool MEDIUM>
HD Nee nee_sample(const Tables& T, V3 p_hit, Pcg32& st) {
  float u_pick = draw1(st);
  float ua = draw1(st), ub = draw1(st);
  draw1(st);  // third EMS uniform: drawn, unused (stream order)
  int eid = 0;
  for (int e = 0; e < T.n_emitters - 1; ++e) eid += T.em[e * ER_COLS + 12] <= u_pick ? 1 : 0;
  const int ne = T.n_emitters;
  float etype = row_at(T.em, ER_COLS, ne, eid, 0);
  Nee r;

  if (etype == (float)EM_AREA) {
    const float* R = nullptr;
    const int n_rows = MEDIUM ? T.te_pad : T.te_cnt;
    for (int k = 0; k < n_rows; ++k) {
      const float* row = T.et + k * ET_COLS;
      if ((int)row[19] == eid && row[18] > ua) {
        R = row;
        break;
      }
    }
    if (MEDIUM && R == nullptr) R = T.et + (T.te_pad - 1) * ET_COLS;
    float z18[18] = {0.0f};
    const float* g = R ? R : z18;
    float cdf_hi = R ? R[18] : 0.0f, cdf_lo = R ? R[20] : 0.0f;
    float ua_re = clampf((ua - cdf_lo) / fmaxf(cdf_hi - cdf_lo, 1e-12f), 0.0f,
                         (float)(1.0 - 1e-7));
    float su = sqrtf(fmaxf(ua_re, 0.0f));
    float b1 = ub * su;
    float b2 = 1.0f - (1.0f - su) - b1;
    V3 p_surf = vadd(load3(g), vadd(vscale(load3(g + 3), b1), vscale(load3(g + 6), b2)));
    V3 n_surf = vnormalize(vadd(load3(g + 9), vadd(vscale(load3(g + 12), b1),
                                                   vscale(load3(g + 15), b2))));
    V3 to_p = vsub(p_surf, p_hit);
    float dist2 = fmaxf(vdot(to_p, to_p), 1e-20f);
    float dist = sqrtf(dist2);
    r.wi = vscale(to_p, 1.0f / dist);
    float cos_em = vdot(n_surf, vneg(r.wi));
    float area_tot = row_at(T.em, ER_COLS, ne, eid, 10);
    float inv_area = 1.0f / fmaxf(area_tot, 1e-20f);
    float pdf_area = inv_area * dist2 / fmaxf(fabsf(cos_em), 1e-12f);
    bool ok = cos_em > 0.0f && pdf_area > EPS && R != nullptr;
    float inv_pdf = ok ? 1.0f / fmaxf(pdf_area, 1e-12f) : 0.0f;
    r.value = V3{row_at(T.em, ER_COLS, ne, eid, 1) * inv_pdf,
                 row_at(T.em, ER_COLS, ne, eid, 2) * inv_pdf,
                 row_at(T.em, ER_COLS, ne, eid, 3) * inv_pdf};
    r.pdf_sa = ok ? pdf_area : 0.0f;
    r.shadow_dist = dist - EPS;
  } else if (etype == (float)EM_POINT || etype == (float)EM_SPOT) {
    V3 to_l = vsub(V3{row_at(T.em, ER_COLS, ne, eid, 4), row_at(T.em, ER_COLS, ne, eid, 5),
                      row_at(T.em, ER_COLS, ne, eid, 6)}, p_hit);
    float d2pt = fmaxf(vdot(to_l, to_l), 1e-20f);
    float dpt = sqrtf(d2pt);
    r.wi = vscale(to_l, 1.0f / dpt);
    if (etype == (float)EM_POINT) {
      r.value = V3{row_at(T.em, ER_COLS, ne, eid, 1) / d2pt,
                   row_at(T.em, ER_COLS, ne, eid, 2) / d2pt,
                   row_at(T.em, ER_COLS, ne, eid, 3) / d2pt};
    } else {  // spot (spotlight.cpp:54-74): cone intensity power/2pi, delta^4 ramp
      float c_start = row_at(T.em, ER_COLS, ne, eid, 16);
      float c_end = row_at(T.em, ER_COLS, ne, eid, 17);
      float cos_theta = -(r.wi.x * row_at(T.em, ER_COLS, ne, eid, 13) +
                          r.wi.y * row_at(T.em, ER_COLS, ne, eid, 14) +
                          r.wi.z * row_at(T.em, ER_COLS, ne, eid, 15));
      float delta = (cos_theta - c_end) / fmaxf(c_start - c_end, 1e-12f);
      float r1 = clampf(delta, 0.0f, 1.0f), r2 = r1 * r1;
      float falloff = cos_theta < c_end ? 0.0f : (cos_theta >= c_start ? 1.0f : r2 * r2);
      float i_norm = falloff / (TWO_PI * fmaxf(1.0f - 0.5f * (c_end + c_start), 1e-12f) * d2pt);
      r.value = V3{row_at(T.em, ER_COLS, ne, eid, 7) * i_norm,
                   row_at(T.em, ER_COLS, ne, eid, 8) * i_norm,
                   row_at(T.em, ER_COLS, ne, eid, 9) * i_norm};
    }
    r.pdf_sa = 1.0f;
    r.shadow_dist = dpt - EPS;
  } else if (etype == (float)EM_DIRECTIONAL) {
    // directionalLight.cpp:90-136: uniform sphere cap around -direction
    float cos_cap = cosf(row_at(T.em, ER_COLS, ne, eid, 18));
    V3 dir_t = vnormalize(V3{row_at(T.em, ER_COLS, ne, eid, 13),
                             row_at(T.em, ER_COLS, ne, eid, 14),
                             row_at(T.em, ER_COLS, ne, eid, 15)});
    V3 sD, tD;
    onb(dir_t, sD, tD);
    float zc = ua * (1.0f - cos_cap) + cos_cap;
    float rc = safe_sqrt(1.0f - zc * zc);
    float thc = TWO_PI * ub;
    r.wi = vneg(to_world(sD, tD, dir_t, V3{rc * cosf(thc), rc * sinf(thc), zc}));
    float pdf_dir = 1.0f / fmaxf(TWO_PI * (1.0f - cos_cap), 1e-12f);
    float inv_pd = 1.0f / pdf_dir;
    r.value = V3{row_at(T.em, ER_COLS, ne, eid, 1) * inv_pd,
                 row_at(T.em, ER_COLS, ne, eid, 2) * inv_pd,
                 row_at(T.em, ER_COLS, ne, eid, 3) * inv_pd};
    r.pdf_sa = pdf_dir;
    r.shadow_dist = BIG;
  } else {  // constant envmap: uniform sphere, pdf 1/4pi
    float z = 2.0f * ua - 1.0f;
    float rr = safe_sqrt(1.0f - z * z);
    float sig = TWO_PI * ub;
    r.wi = V3{rr * cosf(sig), rr * sinf(sig), z};
    r.value = V3{T.env[0] * FOUR_PI, T.env[1] * FOUR_PI, T.env[2] * FOUR_PI};
    r.pdf_sa = (float)(1.0 / (4.0 * PI_D));
    r.shadow_dist = BIG;
  }
  return r;
}

// triangle attributes -> BSDF params (columns of the triangle rows)
HD Bsdf bsdf_from_row(const float* a) {
  Bsdf P;
  P.type = (int)a[21];
  P.alpha = a[22];
  P.int_ior = a[23];
  P.ext_ior = a[24];
  P.ks = a[25];
  P.kd = load3(a + 26);
  P.albedo = load3(a + 29);
  for (int k = 0; k < 10; ++k) P.disney[k] = a[33 + k];
  return P;
}

HD Bsdf bsdf_from_sphere(const float* s) {
  Bsdf P;
  P.type = (int)s[4];
  P.alpha = s[5];
  P.int_ior = s[6];
  P.ext_ior = s[7];
  P.ks = s[8];
  P.kd = load3(s + 9);
  P.albedo = load3(s + 12);
  for (int k = 0; k < 10; ++k) P.disney[k] = s[16 + k];
  return P;
}

HD isect::RayIn ray_in(V3 o, V3 d, float mint) {
  return isect::RayIn{o.x, o.y, o.z, d.x, d.y, d.z, mint};
}

// The carried state of one pixel's loop (the TPU kernel's `body` carry): the
// current sample's ray, throughput and MIS state, the pending shadow ray,
// the sums of the output rows and the counts.
struct Pixel {
  uint32_t pix;  // the image pixel; its column of out is pix - T.pix0
  float px, py;
  Pcg32 st;
  Ray ray;
  float depth, pdf_prev, sh_dist, n_done;
  bool active, prev_disc, sh_pend;
  int started, it;
  V3 thr, sh_o, sh_d, sh_c, aL, aA, aN;
};

// take image pixel `pix`: its first sample's camera ray, empty sums
HD void pixel_begin(const Tables& T, uint32_t pix, Pixel& s) {
  s.pix = pix;
  s.px = (float)(pix % (uint32_t)T.width);
  s.py = (float)(pix / (uint32_t)T.width);
  s.ray = camera_ray(T, pix, s.px, s.py, 0u, s.st);
  s.depth = 0.0f;
  s.active = true;
  s.prev_disc = false;
  s.sh_pend = false;
  s.started = 1;
  s.thr = V3{1.0f, 1.0f, 1.0f};
  s.pdf_prev = 0.0f;
  s.sh_o = V3{0.0f, 0.0f, 0.0f};
  s.sh_d = V3{0.0f, 0.0f, 1.0f};
  s.sh_c = V3{0.0f, 0.0f, 0.0f};
  s.sh_dist = -1.0f;
  s.aL = s.aA = s.aN = V3{0.0f, 0.0f, 0.0f};
  s.n_done = 0.0f;
  s.it = 0;
}

// whether the pixel runs another iteration: it has an active path or a
// pending shadow ray, and has run fewer than n_spp * max_depth + 2
HD bool pixel_live(const Tables& T, const Pixel& s) {
  return s.it < T.n_spp * T.max_depth + 2 && (s.active || s.sh_pend);
}

// the pixel's 16 output values into column s.pix - pix0 of out [16, n_pix]
HD void pixel_store(const Tables& T, const Pixel& s, float* out) {
  const float res[16] = {s.aL.x, s.aL.y, s.aL.z, s.n_done, s.aA.x, s.aA.y, s.aA.z, s.aN.x,
                         s.aN.y, s.aN.z, (float)s.it, 0.0f, 0.0f, 0.0f, 0.0f, 0.0f};
  const size_t col = s.pix - T.pix0;
  for (int r = 0; r < 16; ++r) out[(size_t)r * (size_t)T.n_pix + col] = res[r];
}

// The small branch's fused sweep of the triangle rows in row order: the
// closest hit of s.ray (strict < against the running best: the
// lowest-index minimum) and the any hit of the pending shadow segment.
HD void sweep(const Tables& T, const Pixel& s, float& t_tri, float& u, float& v, int& best_j,
              bool& occ) {
  for (int j = 0; j < T.t_cnt; ++j) {
    const float* tr = T.tri + j * TR_COLS;
    const V3 v0 = load3(tr), e1 = load3(tr + 3), e2 = load3(tr + 6);
    float uu, vv, tt;
    if (mt_test(v0, e1, e2, s.ray.o, s.ray.d, uu, vv, tt) && tt >= s.ray.mint && tt < t_tri) {
      t_tri = tt;
      u = uu;
      v = vv;
      best_j = j;
    }
    if (s.sh_pend && !occ && mt_test(v0, e1, e2, s.sh_o, s.sh_d, uu, vv, tt) && tt >= EPS &&
        tt < s.sh_dist)
      occ = true;
  }
}

// One iteration of a pixel's loop: the bounce of its current path (closest
// hit, the pending shadow ray's any hit, emission, Russian roulette, NEE,
// the BSDF sample) and, when the path ends, the camera ray of the pixel's
// next sample. MEDIUM: walk the LBVH (T.nodes in shared memory); else sweep.
template <bool MIS, bool MEDIUM>
HD void bounce(const Tables& T, Pixel& s) {
  const float pdf_env_dir = T.env[3] > 0.0f ? T.pdf_env : 0.0f;
  ++s.it;
  const bool was = s.active;
  const bool first = s.depth < 0.5f;

  // ---- 1. closest hit (current ray) + any hit (shadow ray)
  float t_tri = s.ray.maxt, u = 0.0f, v = 0.0f;
  int best_j = -1;
  bool occ = false;
  if (MEDIUM) {
    // the LBVH walk, taking the lowest-index minimum of t as the sweep
    // does; then the pending shadow ray's any hit
    int n_visit, n_leaf;
    isect::Best b = {s.ray.maxt, 0.0f, 0.0f, -1};
    isect::walk<false, true, true>(T.nodes, T.n_nodes, T.leaf,
                                   ray_in(s.ray.o, s.ray.d, s.ray.mint), b, n_visit, n_leaf);
    t_tri = b.t;
    u = b.u;
    v = b.v;
    best_j = b.id;
    if (s.sh_pend) {
      isect::Best sb = {s.sh_dist, 0.0f, 0.0f, -1};
      isect::walk<true, false, true>(T.nodes, T.n_nodes, T.leaf, ray_in(s.sh_o, s.sh_d, EPS),
                                     sb, n_visit, n_leaf);
      occ = sb.id >= 0;
    }
  } else {
    sweep(T, s, t_tri, u, v, best_j, occ);
  }
  const bool tri_valid = best_j >= 0;
  if (s.sh_pend && !occ) {
    int s_sid;
    sphere_hit(T.sph, T.n_sph_rows, s.sh_o, s.sh_d, EPS, s.sh_dist, s_sid);
    occ = s_sid >= 0;
  }

  // ---- 2. resolve the pending NEE shadow ray from the last iteration
  if (s.sh_pend && !occ) s.aL = vadd(s.aL, s.sh_c);
  s.sh_pend = false;

  // ---- 3. a sphere hit must beat the best triangle
  int sid;
  float t_sph = sphere_hit(T.sph, T.n_sph_rows, s.ray.o, s.ray.d, s.ray.mint, t_tri, sid);
  const bool sphere_wins = sid >= 0;
  const bool valid = tri_valid || sphere_wins;
  const float t_best = sphere_wins ? t_sph : t_tri;
  V3 p_hit = vadd(s.ray.o, vscale(s.ray.d, valid ? t_best : 1.0f));
  Bsdf P;
  V3 ns;
  int em_id = -1;
  if (sphere_wins) {
    const float* sp = T.sph + sid * SPH_COLS;
    P = bsdf_from_sphere(sp);
    float inv_r = 1.0f / fmaxf(sp[3], 1e-12f);
    ns = V3{(p_hit.x - sp[0]) * inv_r, (p_hit.y - sp[1]) * inv_r, (p_hit.z - sp[2]) * inv_r};
  } else if (tri_valid) {
    const float* a = T.tri + best_j * TR_COLS;
    P = bsdf_from_row(a);
    ns = vnormalize(V3{a[12] + u * a[15] + v * a[18], a[13] + u * a[16] + v * a[19],
                       a[14] + u * a[17] + v * a[20]});
    em_id = (int)a[32];
  }

  // ---- 4. miss -> constant envmap. The NEE side samples a constant
  // envmap uniformly over the sphere, so this MIS weight uses pdf
  // 1/4pi/n_lights (the JAX package's XLA path uses its image CDF
  // instead; the two agree only in expectation).
  if (!valid) {
    if (s.active) {
      float w_env = 1.0f;
      if (MIS && !(first || s.prev_disc)) {
        float denom_env = s.pdf_prev + pdf_env_dir;
        w_env = denom_env > EPS ? s.pdf_prev / fmaxf(denom_env, 1e-20f) : 1.0f;
      }
      s.aL = vadd(s.aL, V3{w_env * s.thr.x * T.env[0], w_env * s.thr.y * T.env[1],
                           w_env * s.thr.z * T.env[2]});
    }
    s.active = false;
  } else {
    // ---- 5. first-hit AOVs
    if (first) {
      s.aA = vadd(s.aA, P.albedo);
      s.aN = vadd(s.aN, ns);
    }
    V3 sfr, tfr;
    onb(ns, sfr, tfr);

    // ---- 6. emitter hit (MATS side)
    const int ne = T.n_emitters;
    if (s.active && em_id >= 0 && vdot(ns, vneg(s.ray.d)) >= 0.0f) {
      float w_mats = 1.0f;
      if (MIS && !(first || s.prev_disc)) {
        float cos_e = vdot(ns, vneg(vnormalize(s.ray.d)));
        V3 to_hit = vsub(p_hit, s.ray.o);
        float dist2 = vdot(to_hit, to_hit);
        float area_tot = row_at(T.em, ER_COLS, ne, em_id, 10);
        float pdf_here = cos_e > 0.0f ? (1.0f / fmaxf(area_tot, 1e-20f)) * dist2 /
                                            fmaxf(fabsf(cos_e), 1e-12f) / T.n_lights
                                      : 0.0f;
        float denom = s.pdf_prev + pdf_here;
        w_mats = denom > EPS ? s.pdf_prev / fmaxf(denom, 1e-20f) : 1.0f;
      }
      s.aL = vadd(s.aL, V3{w_mats * s.thr.x * row_at(T.em, ER_COLS, ne, em_id, 1),
                           w_mats * s.thr.y * row_at(T.em, ER_COLS, ne, em_id, 2),
                           w_mats * s.thr.z * row_at(T.em, ER_COLS, ne, em_id, 3)});
    }

    // ---- 7. Russian roulette (path_mis.cpp:58-71 / raygen.cpp:119-127)
    float u_rr = draw1(s.st);
    float tmax_c = fmaxf(s.thr.x, fmaxf(s.thr.y, s.thr.z));
    if (MIS) {
      float succ = clampf(tmax_c, EPS, 0.99f);
      if (s.active) {
        bool die = u_rr > succ;
        s.thr = vscale(s.thr, 1.0f / succ);
        s.active = !die;
      }
    } else {
      float succ = fminf(tmax_c, 0.99f);
      if (s.active && s.depth >= 2.5f) {
        bool die = u_rr > succ;
        s.thr = vscale(s.thr, 1.0f / fmaxf(succ, 1e-12f));
        s.active = !die;
      }
    }

    V3 wi_l = to_local(sfr, tfr, ns, vneg(vnormalize(s.ray.d)));
    V3 bw;
    float bpdf;
    bool bdisc;
    V3 wo_l;
    if (MIS) {
      // ---- 8. EMS: sample NEE, queue the shadow ray for the next sweep
      Nee nr = nee_sample<MEDIUM>(T, p_hit, s.st);
      bool cand = s.active && (fabsf(nr.value.x) > EPS || fabsf(nr.value.y) > EPS ||
                               fabsf(nr.value.z) > EPS);
      V3 contrib{0.0f, 0.0f, 0.0f};
      float w_ems = 0.0f;
      if (cand) {
        V3 wi_light_l = to_local(sfr, tfr, ns, nr.wi);
        V3 f_l = bsdf_eval(P, wi_l, wi_light_l);
        float cos_l = vdot(nr.wi, ns);
        float pdf_mat_at = bsdf_pdf(P, wi_l, wi_light_l);
        float pdf_ems = nr.pdf_sa / T.n_lights;
        contrib = V3{nr.value.x * cos_l * f_l.x * T.n_lights,
                     nr.value.y * cos_l * f_l.y * T.n_lights,
                     nr.value.z * cos_l * f_l.z * T.n_lights};
        w_ems = pdf_ems + pdf_mat_at > EPS ? pdf_ems / fmaxf(pdf_ems + pdf_mat_at, 1e-20f)
                                           : 0.0f;
      }
      // ---- 9. MATS sample
      float um1 = draw1(s.st), um2 = draw1(s.st);
      wo_l = bsdf_sample(P, wi_l, um1, um2, bw, bpdf, bdisc);
      float amask = (cand && !bdisc) ? w_ems : 0.0f;
      s.sh_pend = amask * contrib.x != 0.0f || amask * contrib.y != 0.0f ||
                  amask * contrib.z != 0.0f;
      s.sh_c = V3{amask * s.thr.x * contrib.x, amask * s.thr.y * contrib.y,
                  amask * s.thr.z * contrib.z};
      s.sh_o = p_hit;
      s.sh_d = nr.wi;
      s.sh_dist = nr.shadow_dist;
      s.pdf_prev = bpdf;
      s.prev_disc = bdisc;
    } else {
      float um1 = draw1(s.st), um2 = draw1(s.st);
      wo_l = bsdf_sample(P, wi_l, um1, um2, bw, bpdf, bdisc);
    }
    if (s.active) {
      s.thr = V3{s.thr.x * bw.x, s.thr.y * bw.y, s.thr.z * bw.z};
      s.active = fabsf(s.thr.x) > 1e-12f || fabsf(s.thr.y) > 1e-12f || fabsf(s.thr.z) > 1e-12f;
    }
    if (s.active) {
      s.ray.o = p_hit;
      s.ray.d = to_world(sfr, tfr, ns, wo_l);
      s.ray.mint = EPS;
      s.ray.maxt = BIG;
    }
  }
  s.depth += 1.0f;

  // ---- 10. termination + regeneration
  const bool end = was && (!s.active || s.depth > (float)T.max_depth - 0.5f);
  if (end) {
    s.n_done += 1.0f;
    if (s.started < T.n_spp) {
      s.ray = camera_ray(T, s.pix, s.px, s.py, (uint32_t)s.started, s.st);
      ++s.started;
      s.depth = 0.0f;
      s.thr = V3{1.0f, 1.0f, 1.0f};
      s.pdf_prev = 0.0f;
      s.prev_disc = false;
      s.active = true;
    } else {
      s.active = false;
    }
  }
}

// The whole loop of image pixel `pix`, its rows into out [16, n_pix].
template <bool MIS, bool MEDIUM>
HD void trace_pixel(const Tables& T, uint32_t pix, float* out) {
  Pixel s;
  pixel_begin(T, pix, s);
  while (pixel_live(T, s)) bounce<MIS, MEDIUM>(T, s);
  pixel_store(T, s, out);
}

#ifdef __CUDACC__
constexpr uint32_t FULL = 0xffffffffu;

// the configuration of the last launch of either branch, for reports
struct LaunchInfo {
  int medium, blocks, threads, blocks_per_sm, smem_bytes;
};
static LaunchInfo g_last = {0, 0, 0, 0, 0};

constexpr int MAX_STAGED_BYTES = 227 * 1024;  // dynamic shared memory a block can take

// persistent blocks: as many as fit on the card at once (the occupancy
// that `threads` and `smem` allow), at most one per `threads` pixels
template <typename K>
cudaError_t launch_persistent(K kernel, int threads, int smem, const Tables& T, float* out,
                              uint32_t* next_pix, cudaStream_t s, int medium) {
  if (next_pix == nullptr || smem > MAX_STAGED_BYTES) return cudaErrorInvalidValue;
  cudaError_t e = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  int dev = 0, n_sm = 0, per_sm = 0;
  if (e == cudaSuccess) e = cudaGetDevice(&dev);
  if (e == cudaSuccess) e = cudaDeviceGetAttribute(&n_sm, cudaDevAttrMultiProcessorCount, dev);
  if (e == cudaSuccess)
    e = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, kernel, threads, smem);
  if (e != cudaSuccess) return e;
  const int need = (T.n_pix + threads - 1) / threads;
  const int fit = n_sm * (per_sm > 1 ? per_sm : 1);
  const int blocks = need < fit ? need : fit;
  g_last = LaunchInfo{medium, blocks, threads, per_sm, smem};
  kernel<<<blocks, threads, smem, s>>>(T, out, next_pix);
  return cudaSuccess;
}

// ---- the small branch: persistent blocks that first copy the scene's
// tables into shared memory (triangle rows, spheres, emissive triangles,
// camera pack, env: at most 27 KB, 2.9 KB for the Cornell box; the emitter
// rows, one per light and so without a bound, stay in global memory), then
// keep every lane on a pixel: a lane whose pixel is done writes its rows
// and takes the next pixel from the counter, one atomicAdd per warp for all
// such lanes.
// 640 threads (20 warps, 96 registers) measured fastest on an H100 against
// 512 (16 warps, 121 registers, no spills) and 768 (PERF.md).
constexpr int SMALL_THREADS = 640;

// floats of the staged tables
inline int small_floats(const Tables& T) {
  return T.t_cnt * TR_COLS + T.n_sph_rows * SPH_COLS + T.te_cnt * ET_COLS + SF_COLS + 4;
}

// copy the tables into s_tab (every segment is a multiple of 4 floats, so
// each starts 16-byte aligned) and return the Tables that point there
__device__ Tables stage_small(const Tables& T, float* s_tab) {
  Tables S = T;
  float* p = s_tab;
  auto stage = [&](const float*& table, int n) {
    for (int i = threadIdx.x; i < n; i += blockDim.x) p[i] = table[i];
    table = p;
    p += n;
  };
  stage(S.tri, T.t_cnt * TR_COLS);
  stage(S.sph, T.n_sph_rows * SPH_COLS);
  stage(S.et, T.te_cnt * ET_COLS);
  stage(S.sf, SF_COLS);
  stage(S.env, 4);
  __syncthreads();
  return S;
}

template <bool MIS>
__global__ void __launch_bounds__(SMALL_THREADS, 1)
    pathk_kernel(Tables T, float* __restrict__ out, uint32_t* __restrict__ next_pix) {
  extern __shared__ __align__(16) float s_tab[];
  const Tables S = stage_small(T, s_tab);
  const uint32_t lane = threadIdx.x & 31u;
  const uint32_t n_pix = (uint32_t)T.n_pix;
  Pixel s;
  bool have = false, more = true;
  for (;;) {
    // the lanes without a pixel take the next ones, in lane order
    const uint32_t need = __ballot_sync(FULL, !have && more);
    if (need) {
      const int leader = __ffs(need) - 1;
      uint32_t base = 0;
      if ((int)lane == leader) base = atomicAdd(next_pix, (uint32_t)__popc(need));
      base = __shfl_sync(FULL, base, leader);
      if (!have && more) {
        const uint32_t c = base + (uint32_t)__popc(need & ((1u << lane) - 1u));
        if (c < n_pix) {
          pixel_begin(S, T.pix0 + c, s);
          have = true;
        } else {
          more = false;  // the counter only grows: no pixel is left
        }
      }
    }
    if (!__any_sync(FULL, have)) break;
    if (have) {
      bounce<MIS, false>(S, s);
      if (!pixel_live(S, s)) {
        pixel_store(S, s, out);
        have = false;
      }
    }
  }
}

template <bool MIS>
cudaError_t launch(const Tables& T, float* out, uint32_t* next_pix, cudaStream_t s) {
  return launch_persistent(pathk_kernel<MIS>, SMALL_THREADS,
                           small_floats(T) * (int)sizeof(float), T, out, next_pix, s, 0);
}

// ---- the medium branch: persistent blocks, each copying the node table
// into shared memory once (a TMA bulk copy on an mbarrier), then taking
// pixels 32 at a time per warp from a counter
constexpr int STAGED_THREADS = 512;
constexpr uint32_t STAGED_CHUNK = 32768;  // bytes per bulk copy

template <bool MIS>
__global__ void __launch_bounds__(STAGED_THREADS, 1)
    pathk_staged_kernel(Tables T, float* __restrict__ out, uint32_t* __restrict__ next_pix) {
  extern __shared__ __align__(128) float s_nodes[];
  __shared__ alignas(8) uint64_t bar;
  const uint32_t bar_a = smem_u32(&bar);
  if (threadIdx.x == 0) {
    asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;" ::"r"(bar_a), "r"(1) : "memory");
    asm volatile("fence.mbarrier_init.release.cluster;" ::: "memory");
  }
  __syncthreads();
  if (threadIdx.x == 0) {
    const uint32_t bytes = (uint32_t)T.n_nodes * isect::NODE_COLS * sizeof(float);
    asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;" ::"r"(bar_a),
                 "r"(bytes)
                 : "memory");
    for (uint32_t off = 0; off < bytes; off += STAGED_CHUNK) {
      const uint32_t n = min(STAGED_CHUNK, bytes - off);
      asm volatile(
          "cp.async.bulk.shared::cluster.global.mbarrier::complete_tx::bytes [%0], [%1], %2, "
          "[%3];" ::"r"(smem_u32(s_nodes) + off),
          "l"(reinterpret_cast<const char*>(T.nodes) + off), "r"(n), "r"(bar_a)
          : "memory");
    }
  }
  mbar_wait(bar_a, 0);
  Tables S = T;
  S.nodes = s_nodes;
  // each warp takes the next 32 pixels from the launch's counter, so every
  // SM keeps working while pixels remain (a fixed stride leaves the blocks
  // with one pixel more per thread running alone at the end)
  const uint32_t lane = threadIdx.x & 31u;
  for (;;) {
    uint32_t base = 0;
    if (lane == 0) base = atomicAdd(next_pix, 32u);
    base = __shfl_sync(FULL, base, 0);
    if (base >= (uint32_t)T.n_pix) break;
    const uint32_t c = base + lane;
    if (c < (uint32_t)T.n_pix) trace_pixel<MIS, true>(S, T.pix0 + c, out);
  }
}

template <bool MIS>
cudaError_t launch_staged(const Tables& T, float* out, uint32_t* next_pix, cudaStream_t s) {
  const int bytes = T.n_nodes * isect::NODE_COLS * (int)sizeof(float);
  if (T.n_nodes < 1) return cudaErrorInvalidValue;
  return launch_persistent(pathk_staged_kernel<MIS>, STAGED_THREADS, bytes, T, out, next_pix, s,
                           1);
}
#endif

}  // namespace pk

#ifdef __CUDACC__
// traces pixels pix0 ... pix0 + n_pix - 1 of the image into out [16, n_pix];
// next_pix: one uint32 that holds 0 at launch, the counter from which the
// kernel's warps take their pixels (both branches; a null one is refused)
extern "C" int pathk_trace_launch(float* out, const float* sf, const float* em,
                                  const float* env, const float* sph, int n_sph_rows,
                                  const float* tri, int t_cnt, const float* nodes, int n_nodes,
                                  const float* leaf, const float* et, int te_cnt, int te_pad,
                                  int pix0, int n_pix, int width, int spp0, int seed,
                                  int n_spp,
                                  int max_depth, int n_emitters, int n_lights, int mis,
                                  int rfilter, int use_dof, uint32_t* next_pix,
                                  void* stream) {
  pk::Tables T;
  T.sf = sf;
  T.em = em;
  T.env = env;
  T.sph = sph;
  T.tri = tri;
  T.et = et;
  T.nodes = nodes;
  T.leaf = leaf;
  T.n_sph_rows = n_sph_rows;
  T.t_cnt = t_cnt;
  T.te_cnt = te_cnt;
  T.te_pad = te_pad;
  T.n_emitters = n_emitters;
  T.n_nodes = n_nodes;
  T.n_lights = (float)n_lights;
  T.pdf_env = (float)(1.0 / (4.0 * pk::PI_D) / (double)T.n_lights);
  T.pix0 = (uint32_t)pix0;
  T.n_pix = n_pix;
  T.width = width;
  T.n_spp = n_spp;
  T.max_depth = max_depth;
  T.rfilter = rfilter;
  T.use_dof = use_dof;
  T.spp0 = (uint32_t)spp0;
  T.seed = (uint32_t)seed;
  cudaStream_t s = (cudaStream_t)stream;
  if (next_pix == nullptr) return (int)cudaErrorInvalidValue;
  const bool medium = t_cnt > pk::VPU_MAX_TRIS;
  if (n_pix > 0) {
    cudaError_t e = medium ? (mis ? pk::launch_staged<true>(T, out, next_pix, s)
                                  : pk::launch_staged<false>(T, out, next_pix, s))
                           : (mis ? pk::launch<true>(T, out, next_pix, s)
                                  : pk::launch<false>(T, out, next_pix, s));
    if (e != cudaSuccess) return (int)e;
  }
  return (int)cudaGetLastError();
}

// the grid, block size, resident blocks per SM and dynamic shared memory of
// the last launch, and whether it was the medium branch
extern "C" void pathk_last_launch(int* medium, int* blocks, int* threads, int* blocks_per_sm,
                                  int* smem_bytes) {
  *medium = pk::g_last.medium;
  *blocks = pk::g_last.blocks;
  *threads = pk::g_last.threads;
  *blocks_per_sm = pk::g_last.blocks_per_sm;
  *smem_bytes = pk::g_last.smem_bytes;
}

extern "C" const char* pathk_error_string(int code) {
  return cudaGetErrorString((cudaError_t)code);
}
#endif
