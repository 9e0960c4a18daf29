// The scan path's shading kernel for Hopper (sm_90a): everything a bounce of
// a path_mis / path_mats sample round does between its intersection launches,
// one thread per lane, one launch per bounce.
//
// The plain version is the torch chain of integrators/path.py (li_path_mis,
// li_path_mats) and the helpers it calls: ops/intersect.py (replay_tri,
// make_interaction), integrators/common.py (trace, nee, first_hit_aovs),
// ops/bsdf.py, ops/disney.py, ops/emitter.py, core/warp.py. That chain is
// the contract: every formula below is its formula in its order of
// operations, which in places differs from the path kernel's library
// (mega.cuh follows the JAX kernel), so the BSDFs and emitters are written
// out here and only the vector algebra, pcg32, Moller-Trumbore, the Duff
// frame, the Beckmann NDF and the Disney helpers that agree are shared.
// Built without FMA contraction (ops/cuda/_build.py), as every unit. Where
// torch on the card divides by a host scalar it multiplies by the scalar's
// float reciprocal, and so does this file (`* inv_n_lights`).
//
// A bounce of an eligible round (ops/cuda/scan.py, integrators/path.py:
// li_path_fused) is three launches on one stream with no host read:
//   1. isect_bvh (or isect_brute) closest hit of the lanes' rays, exactly
//      the chain's rays: a dead lane keeps its last ray, as in the chain;
//   2. shade_kernel<MIS>: per lane
//      - fold the previous bounce's NEE term into L if its shadow ray was
//        unoccluded (the triangles' any hit from launch 3, the analytic
//        spheres tested here), so L sums bounce b's NEE term, then bounce
//        b+1's envmap term, then its emitter term, as the chain adds them;
//      - a dead lane returns: its shadow ray is left empty ([BIG, -1)), so
//        launch 3 tests nothing for it;
//      - replay the winner (triangle by Moller-Trumbore, sphere by the
//        stable quadratic), the shading frame, the BSDF and emitter ids;
//        bounce 0 writes albedo and normal;
//      - the envmap term on a miss, the emitter term on a hit (MIS weights
//        from the previous bounce's pdf, computed lazily);
//      - Russian roulette, then (MIS) the emitter pick, the emitter sample,
//        the BSDF's eval and pdf toward the light: the shadow ray and the
//        pending term w_ems * t * contrib;
//      - the BSDF sample and the lane's new throughput, ray and MIS state;
//      draws in the chain's order: RR 1, pick 1, emitter 2 + 1, BSDF 2; a
//      lane that dies stops drawing (the chain draws for every lane, so
//      only live lanes' streams are the chain's);
//   3. isect_bvh any hit of the shadow rays it wrote (MIS only).
// After the last bounce one fold-only launch adds the last pending term.
//
// What bounds it: per live lane one triangle row (v0, e1, e2, three
// normals: 72 B) or a pass over at most 64 spheres, ~0.3 KB of lane state
// read and written, and a few hundred FP32 operations with a dozen
// transcendentals; a dead lane reads two flags. The lanes of a warp take
// different BSDF and emitter branches.
//
// The per-lane body is a set of HD functions over plain pointers, so it also
// compiles with a host compiler (scan_shade_host below), which the tests
// build with g++ and hold against the chain on the CPU.

#include "mega.cuh"

#ifdef __CUDACC__
#include <cuda_runtime.h>
#endif

namespace sc {

using pk::Pcg32;
using pk::V3;
using pk::load3;
using pk::vadd;
using pk::vdot;
using pk::vscale;
using pk::vsub;

constexpr double PI_D = 3.14159265358979323846;  // core/math.PI
constexpr float PI = (float)PI_D;
constexpr float INV_PI = (float)(1.0 / PI_D);
constexpr float TWO_PI = (float)(2.0 * PI_D);
constexpr float INV_FOURPI = (float)(0.25 / PI_D);
constexpr float EPS = 1e-4f;    // core/math.EPSILON
constexpr float BIG = 3.4e38f;  // ops/bvh.BIG
constexpr int THREADS = 128;

enum { DIFFUSE = 0, MIRROR = 1, DIELECTRIC = 2, MICROFACET = 3, DISNEY = 4 };
enum { EM_POINT = 0, EM_SPOT = 1, EM_AREA = 2, EM_ENVMAP = 3, EM_DIRECTIONAL = 4 };

// The scene's tables, as scene/data.py holds them (float32 / int32,
// row-major); ops/cuda/scan.py: _CScene mirrors this struct.
struct Scene {
  const float *v0, *e1, *e2, *n0, *n1, *n2;  // [T, 3]
  const int* tri_shape;                      // [T]
  const float* sph_c;                        // [S, 3]
  const float* sph_r;                        // [S]
  const int* sph_shape;                      // [S]
  const int *shape_bsdf, *shape_em;          // [shapes]
  const int *b_type, *b_tex;                 // [B]
  const float *b_int, *b_ext, *b_alpha, *b_ks;  // [B]
  const float* b_kd;                         // [B, 3]
  const float* b_dis;                        // [B, 10]
  const float* tex_val;                      // [X, 3]
  const int* e_type;                         // [E]
  const float *e_rad, *e_pos, *e_pow, *e_dir;  // [E, 3]
  const float *e_cs, *e_ce, *e_ang, *e_area;   // [E]
  const int *e_toff, *e_tcnt;                // [E]
  const float* e_cdf;                        // [E, e_cols]
  const float* pick_cdf;                     // [n_pick]
  const float* env;                          // [3] the constant envmap's radiance
  int t_cnt, n_sph, e_cols, n_pick, has_env;
  float n_lights, inv_n_lights;
};

// The lanes' state and one bounce's inputs; ops/cuda/scan.py: _CLanes.
struct Lanes {
  float *ro, *rd;             // [N, 3] the rays launch 1 traced
  const float *mint, *cut;    // [N] their interval (cut: BIG for an infinite maxt)
  const int* tri;             // [N] triangle winner, -1 none (null: no triangles)
  const int* sph;             // [N] sphere-LBVH winner (null: analytic spheres)
  const float* sph_t;         // [N] its t
  const int *occ_tri, *occ_sph;  // [N] the pending shadow rays' any hits (or null)
  float *sh_o, *sh_d;         // [N, 3] shadow rays out
  float *sh_mint, *sh_cut;    // [N]
  float* pending;             // [N, 3] w_ems * t * contrib, before visibility
  float *thr, *L, *albedo, *normal;  // [N, 3]
  float *pdf_prev, *w_prev;   // [N]
  unsigned char *pend, *active, *prev_disc;  // [N] bool
  long long *st_hi, *st_lo;   // [N] pcg32 state as 32-bit words
  const long long *inc_hi, *inc_lo;
  int n;
};

HD V3 vmul(V3 a, V3 b) { return V3{a.x * b.x, a.y * b.y, a.z * b.z}; }
HD V3 vzero() { return V3{0.0f, 0.0f, 0.0f}; }
HD void store3(float* p, V3 a) {
  p[0] = a.x;
  p[1] = a.y;
  p[2] = a.z;
}

// core/math.normalize: a * (1 / sqrt(|a|^2)) where |a|^2 > 1e-20, else 0
HD V3 nrm(V3 a) {
  const float n2 = vdot(a, a);
  const float s = n2 > 1e-20f ? 1.0f / sqrtf(fmaxf(n2, 1e-20f)) : 0.0f;
  return vscale(a, s);
}

// core/math.safe_normalize: a * rsqrt(|a|^2 + 1e-20)
HD V3 safe_nrm(V3 a) { return vscale(a, rsqrtf(vdot(a, a) + 1e-20f)); }

// core/math.safe_sqrt
HD float ssqrt(float x) { return sqrtf(fmaxf(x, 1e-12f)); }

// core/math.fresnel_dielectric
HD float fresnel(float cos_i, float ext, float intr) {
  const bool entering = cos_i > 0.0f;
  const float ei = entering ? ext : intr, et = entering ? intr : ext;
  const float ci = fabsf(cos_i);
  const float eta = ei / et;
  const float sin2 = eta * eta * fmaxf(1.0f - ci * ci, 0.0f);
  const float ct = ssqrt(1.0f - sin2);
  const float rs = (ei * ci - et * ct) / fmaxf(ei * ci + et * ct, 1e-20f);
  const float rp = (et * ci - ei * ct) / fmaxf(et * ci + ei * ct, 1e-20f);
  float f = 0.5f * (rs * rs + rp * rp);
  f = sin2 > 1.0f ? 1.0f : f;
  return fabsf(ei - et) < 1e-12f ? 0.0f : f;
}

// ---------------------------------------------------------------------------
// warps (core/warp.py)
// ---------------------------------------------------------------------------

HD V3 cos_hemi(float s0, float s1) {
  const float rho = sqrtf(s0);
  const float th = s1 * 2.0f * PI;
  const float x = rho * cosf(th), y = rho * sinf(th);
  return V3{x, y, ssqrt(1.0f - (x * x + y * y))};
}

HD V3 beckmann_sample(float s0, float s1, float alpha) {
  const float log_s = logf(fmaxf(1.0f - s0, 1e-38f));
  const float tan2 = -alpha * alpha * log_s;
  const float phi = s1 * 2.0f * PI;
  const float ct = 1.0f / sqrtf(1.0f + tan2);
  const float st = ssqrt(1.0f - ct * ct);
  return V3{st * cosf(phi), st * sinf(phi), ct};
}

// ---------------------------------------------------------------------------
// BSDFs (ops/bsdf.py, ops/disney.py)
// ---------------------------------------------------------------------------

struct Mat {
  int type;
  V3 albedo, kd;
  float ks, alpha, int_ior, ext_ior;
  const float* dis;  // [10]
};

HD Mat load_mat(const Scene& S, int bsdf_id) {
  const int b = bsdf_id < 0 ? 0 : bsdf_id;
  Mat P;
  P.type = S.b_type[b];
  const int tex = S.b_tex[b];
  P.albedo = tex < 0 ? V3{1.0f, 1.0f, 1.0f} : load3(S.tex_val + 3 * tex);
  P.kd = load3(S.b_kd + 3 * b);
  P.ks = S.b_ks[b];
  P.alpha = S.b_alpha[b];
  P.int_ior = S.b_int[b];
  P.ext_ior = S.b_ext[b];
  P.dis = S.b_dis + 10 * b;
  return P;
}

// Smith G1 with core/math.safe_sqrt (mega.cuh's floors at 0)
HD float smith_g1_c(V3 v, V3 m, float alpha) {
  const float ct = v.z;
  const float tan_t = ssqrt(1.0f - ct * ct) / (fabsf(ct) > 1e-8f ? ct : 1e-8f);
  const float a = 1.0f / fmaxf(alpha * fabsf(tan_t), 1e-8f);
  const float a2 = a * a;
  const float approx = (3.535f * a + 2.181f * a2) / (1.0f + 2.276f * a + 2.577f * a2);
  float g = a >= 1.6f ? 1.0f : approx;
  g = fabsf(tan_t) < 1e-8f ? 1.0f : g;
  return vdot(m, v) * ct <= 0.0f ? 0.0f : g;
}

HD V3 mf_eval(const Mat& P, V3 wi, V3 wo) {
  const V3 wh = safe_nrm(vadd(wi, wo));
  const float d = pk::beckmann_d(wh, P.alpha);
  const float f = fresnel(vdot(wh, wi), P.ext_ior, P.int_ior);
  const float g = smith_g1_c(wi, wh, P.alpha) * smith_g1_c(wo, wh, P.alpha);
  const float denom = 4.0f * wi.z * wo.z;
  const float spec = P.ks * d * f * g / (fabsf(denom) > 1e-12f ? denom : 1e-12f);
  if (!(wo.z > 0.0f)) return vzero();
  return V3{P.kd.x * INV_PI + spec, P.kd.y * INV_PI + spec, P.kd.z * INV_PI + spec};
}

HD float mf_pdf(const Mat& P, V3 wi, V3 wo) {
  const V3 wh = safe_nrm(vadd(wi, wo));
  const float d = pk::beckmann_d(wh, P.alpha);
  const float q = 4.0f * vdot(wo, wh);
  const float part1 = P.ks * d * wh.z / (fabsf(q) > 1e-12f ? q : 1e-12f);
  const float part2 = (1.0f - P.ks) * wo.z * INV_PI;
  return wo.z > 0.0f ? part1 + part2 : 0.0f;
}

HD V3 disney_eval(const Mat& P, V3 L, V3 V) {
  const float metallic = P.dis[0], subsurface = P.dis[1], specular = P.dis[2],
              roughness = P.dis[3], spec_tint = P.dis[4], aniso = P.dis[5], sheen = P.dis[6],
              sheen_tint = P.dis[7], clearcoat = P.dis[8], cc_gloss = P.dis[9];
  const float ndotl = L.z, ndotv = V.z;
  const bool valid = ndotl >= EPS && ndotv >= EPS;
  const V3 H = safe_nrm(vadd(L, V));
  const float ndoth = H.z;
  const float ldoth = vdot(L, H);
  const float base[3] = {P.albedo.x, P.albedo.y, P.albedo.z};
  float cd[3];
  for (int c = 0; c < 3; ++c) cd[c] = powf(fmaxf(base[c], 1e-6f), 2.2f);
  const float cdlum = 0.3f * cd[0] + 0.6f * cd[1] + 0.1f * cd[2];
  const float fl = pk::schlick_fresnel(ndotl), fv = pk::schlick_fresnel(ndotv);
  const float fd90 = 0.5f + 2.0f * ldoth * ldoth * roughness;
  const float fd = (1.0f + (fd90 - 1.0f) * fl) * (1.0f + (fd90 - 1.0f) * fv);
  const float fss90 = ldoth * ldoth * roughness;
  const float fss = (1.0f + (fss90 - 1.0f) * fl) * (1.0f + (fss90 - 1.0f) * fv);
  const float ss = 1.25f * (fss * (1.0f / fmaxf(ndotl + ndotv, 1e-8f) - 0.5f) + 0.5f);
  const float aspect = sqrtf(1.0f - aniso * 0.9f);
  const float ax = fmaxf(roughness * roughness / aspect, 0.001f);
  const float ay = fmaxf(roughness * roughness * aspect, 0.001f);
  const float hx = H.x / ax, hy = H.y / ay;
  const float s = hx * hx + hy * hy + ndoth * ndoth;
  const float ds = 1.0f / fmaxf(PI * ax * ay * (s * s), 1e-12f);
  const float fh = pk::schlick_fresnel(ldoth);
  const float gs = pk::smith_g_ggx_aniso(ndotl, L.x, L.y, ax, ay) *
                   pk::smith_g_ggx_aniso(ndotv, V.x, V.y, ax, ay);
  // GTR1 clearcoat at mix(0.1, 0.001, gloss)
  const float a_cc = fmaxf(0.1f + (float)(0.001 - 0.1) * cc_gloss, 1e-4f);
  const float a2 = a_cc * a_cc;
  const float t_cc = 1.0f + (a2 - 1.0f) * ndoth * ndoth;
  const float dr = a_cc >= 1.0f ? INV_PI : (a2 - 1.0f) / (PI * logf(a2) * t_cc);
  const float fr = 0.04f + (float)(1.0 - 0.04) * fh;
  const float gr = pk::smith_g_ggx(ndotl, 0.25f) * pk::smith_g_ggx(ndotv, 0.25f);
  const float mixd = fd + (ss - fd) * subsurface;
  const float cc = 0.25f * clearcoat * gr * fr * dr;
  float fin[3];
  for (int c = 0; c < 3; ++c) {
    const float ctint = cdlum > 0.0f ? cd[c] / fmaxf(cdlum, 1e-12f) : 1.0f;
    const float a = specular * 0.08f * (1.0f + (ctint - 1.0f) * spec_tint);
    const float cspec0 = a + (cd[c] - a) * metallic;
    const float csheen = 1.0f + (ctint - 1.0f) * sheen_tint;
    const float fs = cspec0 + (1.0f - cspec0) * fh;
    const float fsheen = fh * sheen * csheen;
    fin[c] = (INV_PI * mixd * cd[c] + fsheen) * (1.0f - metallic) + (gs * ds) * fs + cc;
  }
  const float lum = fin[0] * 0.212671f + fin[1] * 0.715160f + fin[2] * 0.072169f;
  if (lum > 1.0f)
    for (int c = 0; c < 3; ++c) fin[c] = fin[c] / fmaxf(lum, 1e-12f);
  if (!valid) return vzero();
  return V3{fin[0], fin[1], fin[2]};
}

// f(wi, wo) under solid angle; discrete types 0
HD V3 bsdf_eval(const Mat& P, V3 wi, V3 wo) {
  switch (P.type) {
    case DIFFUSE:
      return (wi.z > 0.0f && wo.z > 0.0f) ? vscale(P.albedo, INV_PI) : vzero();
    case MICROFACET:
      return mf_eval(P, wi, wo);
    case DISNEY:
      return disney_eval(P, wi, wo);
    default:
      return vzero();
  }
}

HD float bsdf_pdf(const Mat& P, V3 wi, V3 wo) {
  if (P.type == DIFFUSE || P.type == DISNEY)
    return (wi.z > 0.0f && wo.z > 0.0f) ? INV_PI * wo.z : 0.0f;
  if (P.type == MICROFACET) return mf_pdf(P, wi, wo);
  return 0.0f;
}

// ops/bsdf.py: sample_bsdf for one lane: wo, and the weight, pdf and
// whether the event is discrete
HD V3 bsdf_sample(const Mat& P, V3 wi, float u0, float u1, V3& w, float& pdf, bool& disc) {
  const float cos_i = wi.z;
  disc = P.type == MIRROR || P.type == DIELECTRIC;
  pdf = 0.0f;
  if (P.type == MIRROR) {
    const float k = cos_i > 0.0f ? 1.0f : 0.0f;
    w = V3{k, k, k};
    return V3{-wi.x, -wi.y, wi.z};
  }
  if (P.type == DIELECTRIC) {
    const float fr = fresnel(cos_i, P.ext_ior, P.int_ior);
    const bool entering = cos_i >= 0.0f;
    const float eta = entering ? P.ext_ior / P.int_ior : P.int_ior / P.ext_ior;
    const float nz = entering ? 1.0f : -1.0f;
    const float wdn = wi.z * nz;
    const float sq = ssqrt(1.0f - eta * eta * (1.0f - wdn * wdn));
    if (u0 < fr) {
      w = V3{1.0f, 1.0f, 1.0f};
      return V3{-wi.x, -wi.y, wi.z};
    }
    const float k = 1.0f / (eta * eta);
    w = V3{k, k, k};
    const float sn = sq * nz;
    return V3{-eta * (wi.x - 0.0f) - sn * 0.0f, -eta * (wi.y - 0.0f) - sn * 0.0f,
              -eta * (wi.z - wdn * nz) - sn * 1.0f};
  }
  if (P.type == MICROFACET) {
    const float ks = P.ks;
    V3 wo;
    if (u1 < ks) {
      const V3 wh = beckmann_sample(u0, u1 / fmaxf(ks, 1e-8f), P.alpha);
      const float dw = 2.0f * vdot(wi, wh);
      wo = V3{dw * wh.x - wi.x, dw * wh.y - wi.y, dw * wh.z - wi.z};
    } else {
      wo = cos_hemi(u0, (u1 - ks) / fmaxf(1.0f - ks, 1e-8f));
    }
    const V3 f = mf_eval(P, wi, wo);
    const float p = mf_pdf(P, wi, wo);
    const float scale = wo.z / fmaxf(p, 1e-12f);
    const bool ok = wo.z > 0.0f && cos_i >= 0.0f && p > 1e-12f;
    w = ok ? vscale(f, scale) : vzero();
    pdf = p;
    return wo;
  }
  const V3 wo = cos_hemi(u0, u1);
  if (P.type == DISNEY) {
    const V3 f = disney_eval(P, wi, wo);
    const float p = (wi.z > 0.0f && wo.z > 0.0f) ? INV_PI * wo.z : 0.0f;
    w = (wi.z > 0.0f && p >= EPS) ? vscale(f, PI) : vzero();
    pdf = p;
    return wo;
  }
  w = cos_i > 0.0f ? P.albedo : vzero();
  pdf = cos_i > 0.0f ? INV_PI * fmaxf(wo.z, 0.0f) : 0.0f;
  return wo;
}

// ---------------------------------------------------------------------------
// emitters (ops/emitter.py, ops/envmap.py for a constant map)
// ---------------------------------------------------------------------------

// torch.searchsorted(cdf, u, right=True): the entries <= u of a sorted row
HD int upper_bound(const float* cdf, int n, float u) {
  int lo = 0, hi = n;
  while (lo < hi) {
    const int mid = (lo + hi) >> 1;
    if (cdf[mid] <= u)
      lo = mid + 1;
    else
      hi = mid;
  }
  return lo;
}

struct ESample {
  V3 wi, value;
  float pdf, cut;  // cut: the shadow ray's cutoff (BIG for an infinite one)
};

HD ESample sample_emitter(const Scene& S, int em, V3 ref, float u0, float u1) {
  const int e = em < 0 ? 0 : em;
  const int type = S.e_type[e];
  const V3 rad = load3(S.e_rad + 3 * e);
  ESample r;
  if (type == EM_AREA) {
    // an area-weighted triangle of the mesh (sampleReuse), a uniform point on it
    const float* cdf = S.e_cdf + (size_t)e * S.e_cols;
    int local = upper_bound(cdf, S.e_cols, u0);
    local = local < 0 ? 0 : local;
    local = local < S.e_tcnt[e] - 1 ? local : S.e_tcnt[e] - 1;
    const float lo = local > 0 ? cdf[local - 1] : 0.0f;
    const float hi = cdf[local];
    const float ux = pk::clampf((u0 - lo) / fmaxf(hi - lo, 1e-12f), 0.0f, (float)(1.0 - 1e-7));
    int tri = S.e_toff[e] + local;
    const int last = S.t_cnt - 1 > 0 ? S.t_cnt - 1 : 0;
    tri = tri < 0 ? 0 : (tri > last ? last : tri);
    const float su1 = sqrtf(ux);
    const float bu = 1.0f - su1;
    const float bv = u1 * su1;
    const float bw = 1.0f - bu - bv;
    const V3 v0 = load3(S.v0 + 3 * tri), e1 = load3(S.e1 + 3 * tri), e2 = load3(S.e2 + 3 * tri);
    const V3 p = vadd(vadd(v0, vscale(e1, bv)), vscale(e2, bw));
    const V3 n = nrm(vadd(vadd(vscale(load3(S.n0 + 3 * tri), bu), vscale(load3(S.n1 + 3 * tri), bv)),
                          vscale(load3(S.n2 + 3 * tri), bw)));
    const float inv_area = 1.0f / fmaxf(S.e_area[e], 1e-20f);
    const V3 to_p = vsub(p, ref);
    const float dist2 = vdot(to_p, to_p);
    const float dist = sqrtf(fmaxf(dist2, 1e-20f));
    r.wi = V3{to_p.x / dist, to_p.y / dist, to_p.z / dist};
    const float cos_em = vdot(n, V3{-r.wi.x, -r.wi.y, -r.wi.z});
    const float pdf = inv_area * dist2 / fmaxf(fabsf(cos_em), 1e-12f);
    const bool ok = cos_em > 0.0f && pdf > EPS;
    const float c = fmaxf(pdf, 1e-12f);
    r.value = ok ? V3{rad.x / c, rad.y / c, rad.z / c} : vzero();
    r.pdf = pdf;
    r.cut = dist - EPS;
  } else if (type == EM_POINT || type == EM_SPOT) {
    const V3 to_l = vsub(load3(S.e_pos + 3 * e), ref);
    const float d2 = fmaxf(vdot(to_l, to_l), 1e-20f);
    const float d = sqrtf(d2);
    r.wi = V3{to_l.x / d, to_l.y / d, to_l.z / d};
    if (type == EM_POINT) {
      r.value = V3{rad.x / d2, rad.y / d2, rad.z / d2};
    } else {  // spotlight.cpp:54-74: power / 2 pi over the cone, delta^4 ramp
      const float cs = S.e_cs[e], ce = S.e_ce[e];
      const float norm = fmaxf(1.0f - 0.5f * (ce + cs), 1e-12f);
      const V3 pw = vscale(load3(S.e_pow + 3 * e), 1.0f / TWO_PI);
      const V3 dir = load3(S.e_dir + 3 * e);
      const float cos_t = vdot(V3{-r.wi.x, -r.wi.y, -r.wi.z}, dir);
      const float delta = (cos_t - ce) / fmaxf(cs - ce, 1e-12f);
      const float ramp = powf(pk::clampf(delta, 0.0f, 1.0f), 4.0f);
      const float fall = cos_t < ce ? 0.0f : (cos_t >= cs ? 1.0f : ramp);
      r.value = V3{pw.x / norm * fall / d2, pw.y / norm * fall / d2, pw.z / norm * fall / d2};
    }
    r.pdf = 1.0f;
    r.cut = d - EPS;
  } else if (type == EM_DIRECTIONAL) {  // directionalLight.cpp:90-136: a cap around -direction
    const float cos_cap = cosf(S.e_ang[e]);
    const float z = u0 * (1.0f - cos_cap) + cos_cap;
    const float rr = ssqrt(1.0f - z * z);
    const float th = u1 * 2.0f * PI;
    const V3 loc{rr * cosf(th), rr * sinf(th), z};
    const V3 dir = load3(S.e_dir + 3 * e);
    V3 fs, ft;
    pk::onb(dir, fs, ft);
    const V3 w = pk::to_world(fs, ft, dir, loc);
    r.wi = V3{-w.x, -w.y, -w.z};
    r.pdf = 1.0f / fmaxf(TWO_PI * (1.0f - cos_cap), 1e-12f);
    r.value = V3{rad.x / r.pdf, rad.y / r.pdf, rad.z / r.pdf};
    r.cut = BIG;
  } else {  // the constant envmap: uniform over the sphere
    const float z = 2.0f * u0 - 1.0f;
    const float rr = ssqrt(1.0f - z * z);
    const float sig = TWO_PI * u1;
    r.wi = V3{rr * cosf(sig), rr * sinf(sig), z};
    r.pdf = INV_FOURPI;
    const float c = fmaxf(INV_FOURPI, 1e-20f);
    r.value = V3{S.env[0] / c, S.env[1] / c, S.env[2] / c};
    r.cut = BIG;
  }
  return r;
}

// ---------------------------------------------------------------------------
// intersections: the winner's replay and the analytic spheres
// ---------------------------------------------------------------------------

// ops/intersect.py: _ray_spheres, the roots of one sphere
HD bool sphere_roots(V3 o, V3 d, const float* c, float r, float floor_, float& tn, float& tf) {
  const float ox = o.x - c[0], oy = o.y - c[1], oz = o.z - c[2];
  const float a = d.x * d.x + d.y * d.y + d.z * d.z;
  const float b = 2.0f * (ox * d.x + oy * d.y + oz * d.z);
  const float cc = (ox * ox + oy * oy + oz * oz) - r * r;
  const float disc = b * b - 4.0f * a * cc;
  const float sq = sqrtf(fmaxf(disc, floor_));
  const float sgn = b > 0.0f ? 1.0f : (b < 0.0f ? -1.0f : 0.0f);
  const float q = -0.5f * (b + sgn * sq);
  const float t0 = q / a;
  const float t1 = cc / (fabsf(q) > 1e-20f ? q : 1e-20f);
  tn = fminf(t0, t1);
  tf = fmaxf(t0, t1);
  return disc >= 0.0f;
}

// the nearest analytic sphere in [mint, best), first index among equals:
// its t and index, or BIG and -1
HD float nearest_sphere(const Scene& S, V3 o, V3 d, float mint, float best, int& j) {
  float tj = BIG;
  int jj = 0;
  for (int k = 0; k < S.n_sph; ++k) {
    float tn, tf;
    const bool ok = sphere_roots(o, d, S.sph_c + 3 * k, S.sph_r[k], 0.0f, tn, tf);
    const float tc = (ok && tn >= mint && tn < best) ? tn : ((ok && tf >= mint && tf < best) ? tf : BIG);
    if (tc < tj) {
      tj = tc;
      jj = k;
    }
  }
  j = (S.n_sph > 0 && tj < best) ? jj : -1;
  return tj;
}

// a shadow ray's occlusion: its triangles' and LBVH spheres' any hit from
// the launch after the last shade, and the analytic spheres here
HD bool occluded(const Scene& S, const Lanes& Q, int i) {
  if (Q.occ_tri && Q.occ_tri[i] >= 0) return true;
  if (Q.occ_sph) return Q.occ_sph[i] >= 0;
  if (S.n_sph == 0) return false;
  int j;
  nearest_sphere(S, load3(Q.sh_o + 3 * i), load3(Q.sh_d + 3 * i), Q.sh_mint[i], Q.sh_cut[i], j);
  return j >= 0;
}

// a lane with nothing for the next any-hit launch to test
HD void no_shadow(const Lanes& Q, int i) {
  Q.sh_mint[i] = BIG;
  Q.sh_cut[i] = -1.0f;
}

// add the pending NEE term of the last bounce where its shadow ray is clear
HD bool fold_lane(const Scene& S, const Lanes& Q, int i) {
  if (!Q.pend[i]) return false;
  if (!occluded(S, Q, i)) store3(Q.L + 3 * i, vadd(load3(Q.L + 3 * i), load3(Q.pending + 3 * i)));
  Q.pend[i] = 0;
  return true;
}

HD Pcg32 load_rng(const Lanes& Q, int i) {
  Pcg32 p;
  p.state = ((uint64_t)Q.st_hi[i] << 32) | (uint64_t)Q.st_lo[i];
  p.inc = ((uint64_t)Q.inc_hi[i] << 32) | (uint64_t)Q.inc_lo[i];
  return p;
}

HD void store_rng(const Lanes& Q, int i, const Pcg32& p) {
  Q.st_hi[i] = (long long)(p.state >> 32);
  Q.st_lo[i] = (long long)(p.state & 0xFFFFFFFFull);
}

// One bounce of lane i (li_path_mis with MIS, else li_path_mats).
template <bool MIS>
HD void shade_lane(const Scene& S, const Lanes& Q, int i, int bounce) {
  const bool had = MIS ? fold_lane(S, Q, i) : false;
  if (!Q.active[i]) {
    if (MIS && had) no_shadow(Q, i);
    return;
  }
  const bool first = bounce == 0;
  const V3 o = load3(Q.ro + 3 * i), d = load3(Q.rd + 3 * i);
  const float mint = Q.mint[i];

  // ---- the winner's replay (ops/intersect.py: intersect, make_interaction)
  float best = Q.cut[i], bu = 0.0f, bv = 0.0f;
  int kind = 0, prim = 0;  // 0 none, 1 triangle, 2 sphere
  const int tid = Q.tri ? Q.tri[i] : -1;
  if (tid >= 0) {
    float t, u, v;
    pk::mt_test(load3(S.v0 + 3 * tid), load3(S.e1 + 3 * tid), load3(S.e2 + 3 * tid), o, d, u, v,
                t);
    best = t;
    bu = u;
    bv = v;
    kind = 1;
    prim = tid;
  }
  if (Q.sph) {
    const int sid = Q.sph[i];
    if (sid >= 0) {  // ops/bvh.py: replay_sphere, the root nearer the walk's t
      float tn, tf;
      sphere_roots(o, d, S.sph_c + 3 * sid, S.sph_r[sid], 1e-20f, tn, tf);
      const float td = Q.sph_t[i];
      best = fabsf(tn - td) <= fabsf(tf - td) ? tn : tf;
      kind = 2;
      prim = sid;
    }
  } else if (S.n_sph > 0) {
    int j;
    const float tj = nearest_sphere(S, o, d, mint, best, j);
    if (j >= 0) {
      best = tj;
      kind = 2;
      prim = j;
    }
  }
  const bool valid = kind != 0;
  const float ts = valid ? best : 1.0f;
  const V3 p{o.x + d.x * ts, o.y + d.y * ts, o.z + d.z * ts};
  V3 ns = vzero();
  int shape = -1;
  if (kind == 1) {
    const float w = 1.0f - bu - bv;
    ns = nrm(vadd(vadd(vscale(load3(S.n0 + 3 * prim), w), vscale(load3(S.n1 + 3 * prim), bu)),
                  vscale(load3(S.n2 + 3 * prim), bv)));
    shape = S.tri_shape[prim];
  } else if (kind == 2) {
    const V3 c = load3(S.sph_c + 3 * prim);
    const float r = fmaxf(S.sph_r[prim], 1e-20f);
    ns = nrm(V3{(p.x - c.x) / r, (p.y - c.y) / r, (p.z - c.z) / r});
    shape = S.sph_shape[prim];
  }
  // integrators/common.py: trace (no normal maps)
  const int sidx = shape < 0 ? 0 : shape;
  const int bsdf_id = valid ? S.shape_bsdf[sidx] : 0;
  const int em_id = valid ? S.shape_em[sidx] : -1;
  const V3 fn = nrm(ns);
  V3 fs, ft;
  pk::onb(fn, fs, ft);
  const Mat P = load_mat(S, bsdf_id);
  if (first) {  // integrators/common.py: first_hit_aovs
    store3(Q.albedo + 3 * i, valid ? P.albedo : vzero());
    store3(Q.normal + 3 * i, valid ? fn : vzero());
  }

  V3 t = load3(Q.thr + 3 * i), L = load3(Q.L + 3 * i);
  const float pdf_prev = MIS ? Q.pdf_prev[i] : 0.0f;
  const bool prev_disc = MIS ? Q.prev_disc[i] != 0 : false;

  // ---- a miss: the envmap term, and the lane ends
  if (!valid) {
    if (S.has_env) {
      const V3 env = load3(S.env);
      float w_env = 1.0f;
      if (MIS) {
        const float pdf_env = INV_FOURPI * S.inv_n_lights;
        const float denom = pdf_prev + pdf_env;
        w_env = denom > EPS ? pdf_prev / fmaxf(denom, 1e-20f) : 1.0f;
        w_env = (prev_disc || first) ? 1.0f : w_env;
      }
      L = vadd(L, vmul(vscale(t, w_env), env));
      store3(Q.L + 3 * i, L);
    }
    Q.active[i] = 0;
    if (MIS) no_shadow(Q, i);
    return;
  }

  // ---- an emitter hit
  const V3 dn = nrm(d);
  float w_mats = 1.0f;
  if (MIS) {
    float pdf_here = 0.0f;
    if (em_id >= 0 && S.e_type[em_id] == EM_AREA) {
      const float cos_e = vdot(fn, V3{-dn.x, -dn.y, -dn.z});
      const float inv_area = 1.0f / fmaxf(S.e_area[em_id], 1e-20f);
      const V3 dp = vsub(p, o);
      const float dist2 = vdot(dp, dp);
      pdf_here = cos_e > 0.0f ? inv_area * dist2 / fmaxf(fabsf(cos_e), 1e-12f) : 0.0f;
    }
    pdf_here = pdf_here * S.inv_n_lights;
    const float denom = pdf_prev + pdf_here;
    w_mats = denom > EPS ? pdf_prev / fmaxf(denom, 1e-20f) : Q.w_prev[i];
    w_mats = (prev_disc || first) ? 1.0f : w_mats;
  }
  if (em_id >= 0 && S.e_type[em_id] == EM_AREA &&
      vdot(fn, V3{-dn.x, -dn.y, -dn.z}) >= 0.0f) {
    const V3 le = load3(S.e_rad + 3 * em_id);
    L = vadd(L, MIS ? vmul(vscale(t, w_mats), le) : vmul(t, le));
  }

  // ---- Russian roulette (path_mis.cpp:58-71, path_mats.cpp:47-58)
  Pcg32 st = load_rng(Q, i);
  const float u_rr = pk::draw1(st);
  const float tmax = fmaxf(fmaxf(t.x, t.y), t.z);
  bool die = false;
  if (MIS) {
    const float succ = pk::clampf(tmax, EPS, 0.99f);
    die = u_rr > succ;
    t = V3{t.x / succ, t.y / succ, t.z / succ};
  } else if (bounce >= 3) {
    const float succ = fminf(tmax, 0.99f);
    die = u_rr > succ;
    const float c = fmaxf(succ, 1e-12f);
    t = V3{t.x / c, t.y / c, t.z / c};
  }
  if (die) {
    store3(Q.L + 3 * i, L);
    store_rng(Q, i, st);
    Q.active[i] = 0;
    if (MIS) no_shadow(Q, i);
    return;
  }

  // ---- NEE (path_mis.cpp:74-106): the shadow ray and the term it gates
  const V3 wo_l = pk::to_local(fs, ft, fn, V3{-dn.x, -dn.y, -dn.z});
  float w_ems = 0.0f;
  V3 contrib = vzero();
  if (MIS) {
    const float u_pick = pk::draw1(st);
    int em = upper_bound(S.pick_cdf, S.n_pick, u_pick);
    em = em < S.n_pick - 1 ? em : S.n_pick - 1;
    const float ua = pk::draw1(st), ub = pk::draw1(st);
    pk::draw1(st);  // the third uniform: drawn, used by volume emitters only
    const ESample es = sample_emitter(S, em, p, ua, ub);
    const V3 wi_l = pk::to_local(fs, ft, fn, es.wi);
    const bool nonzero =
        fabsf(es.value.x) > EPS || fabsf(es.value.y) > EPS || fabsf(es.value.z) > EPS;
    if (nonzero) {
      const V3 f = bsdf_eval(P, wo_l, wi_l);
      const float cosv = vdot(es.wi, fn);
      contrib = V3{es.value.x * cosv * f.x * S.n_lights, es.value.y * cosv * f.y * S.n_lights,
                   es.value.z * cosv * f.z * S.n_lights};
      const float pdf_mat = bsdf_pdf(P, wo_l, wi_l);
      const float pdf_e = es.pdf * S.inv_n_lights;
      const float sum = pdf_e + pdf_mat;
      w_ems = sum > EPS ? pdf_e / fmaxf(sum, 1e-20f) : 0.0f;
      store3(Q.sh_o + 3 * i, p);
      store3(Q.sh_d + 3 * i, es.wi);
      Q.sh_mint[i] = EPS;
      Q.sh_cut[i] = es.cut;
    } else {
      no_shadow(Q, i);
    }
    Q.pend[i] = nonzero;
  }

  // ---- the BSDF sample (path_mis.cpp:108-133)
  const float u0 = pk::draw1(st), u1 = pk::draw1(st);
  V3 bw;
  float bpdf;
  bool bdisc;
  const V3 wo = bsdf_sample(P, wo_l, u0, u1, bw, bpdf, bdisc);
  if (MIS) {
    w_ems = bdisc ? 0.0f : w_ems;
    store3(Q.pending + 3 * i, vmul(vscale(t, w_ems), contrib));
  }
  t = vmul(t, bw);
  const bool alive = fabsf(t.x) > 1e-12f || fabsf(t.y) > 1e-12f || fabsf(t.z) > 1e-12f;
  if (alive) {
    store3(Q.ro + 3 * i, p);
    store3(Q.rd + 3 * i, pk::to_world(fs, ft, fn, wo));
  }
  store3(Q.thr + 3 * i, t);
  store3(Q.L + 3 * i, L);
  store_rng(Q, i, st);
  Q.active[i] = alive;
  if (MIS) {
    Q.pdf_prev[i] = bpdf;
    Q.prev_disc[i] = bdisc;
    Q.w_prev[i] = w_mats;
  }
}

}  // namespace sc

#ifdef __CUDACC__

namespace sc {

template <bool MIS>
__global__ void __launch_bounds__(THREADS)
    shade_kernel(const Scene S, const Lanes Q, int bounce, int fold_only) {
  const int i = blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= Q.n) return;
  if (fold_only) {
    fold_lane(S, Q, i);
    return;
  }
  shade_lane<MIS>(S, Q, i, bounce);
}

}  // namespace sc

// One bounce of every lane (or, with fold_only, the last pending NEE terms)
// on `stream`; returns the launch's cudaError.
extern "C" int scan_shade_launch(const sc::Scene* scene, const sc::Lanes* lanes, int bounce,
                                 int mis, int fold_only, void* stream) {
  if (scene == nullptr || lanes == nullptr || lanes->n <= 0) return (int)cudaErrorInvalidValue;
  const int blocks = (lanes->n + sc::THREADS - 1) / sc::THREADS;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (mis)
    sc::shade_kernel<true><<<blocks, sc::THREADS, 0, s>>>(*scene, *lanes, bounce, fold_only);
  else
    sc::shade_kernel<false><<<blocks, sc::THREADS, 0, s>>>(*scene, *lanes, bounce, fold_only);
  return (int)cudaGetLastError();
}

#else

// The same bounce on the host, lane after lane (the tests' g++ build).
extern "C" void scan_shade_host(const sc::Scene* scene, const sc::Lanes* lanes, int bounce,
                                int mis, int fold_only) {
  for (int i = 0; i < lanes->n; ++i) {
    if (fold_only)
      sc::fold_lane(*scene, *lanes, i);
    else if (mis)
      sc::shade_lane<true>(*scene, *lanes, i, bounce);
    else
      sc::shade_lane<false>(*scene, *lanes, i, bounce);
  }
}

#endif  // __CUDACC__
