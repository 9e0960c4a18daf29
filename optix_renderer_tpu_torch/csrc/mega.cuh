// Device library of the path kernel (csrc/pathk.cu), one thread per pixel.
//
// Counterpart of optix_renderer_tpu/ops/pallas/mega.py and of its plain
// torch twin ops/cuda/mega.py: vector algebra, pcg32 + tea, Moller-Trumbore
// and sphere hits, per-id table reads, the five BSDFs' sample / eval / pdf
// and the Disney BRDF. The formulas and their order of operations are those of the torch
// twin, so the kernel tracks the plain version per pixel; every literal is
// a float literal so no expression is silently evaluated in double.
//
// Table layouts (float32, row-major) are documented in ops/cuda/mega.py
// and ops/cuda/pathk.py. Integer ids are ints with -1 for none; a read of
// id -1 returns zeros.
#pragma once

#include <stdint.h>
#include <math.h>
#include <string.h>

// HD: device code under nvcc; plain inline C++ elsewhere, so the per-pixel
// logic also compiles with a host compiler (rsqrtf then is 1/sqrtf).
#ifdef __CUDACC__
#define HD __device__ __forceinline__
#else
#define HD inline
inline float rsqrtf(float x) { return 1.0f / sqrtf(x); }
#endif

namespace pk {

constexpr double PI_D = 3.14159265358979;
constexpr float PI = (float)PI_D;
constexpr float INV_PI = (float)(1.0 / PI_D);
constexpr float TWO_PI = (float)(2.0 * PI_D);
constexpr float FOUR_PI = (float)(4.0 * PI_D);
constexpr float BIG = 3.4e38f;
constexpr float EPS = 1e-4f;

enum { BSDF_DIFFUSE = 0, BSDF_MIRROR = 1, BSDF_DIELECTRIC = 2, BSDF_MICROFACET = 3,
       BSDF_DISNEY = 4 };
enum { EM_POINT = 0, EM_SPOT = 1, EM_AREA = 2, EM_ENVMAP = 3, EM_DIRECTIONAL = 4 };
constexpr int ER_COLS = 24, ET_COLS = 24, SPH_COLS = 32, TR_COLS = 48, SF_COLS = 40;

// ---------------------------------------------------------------------------
// vectors
// ---------------------------------------------------------------------------

struct V3 {
  float x, y, z;
};

HD V3 v3(float x, float y, float z) { return V3{x, y, z}; }
HD V3 vadd(V3 a, V3 b) { return V3{a.x + b.x, a.y + b.y, a.z + b.z}; }
HD V3 vsub(V3 a, V3 b) { return V3{a.x - b.x, a.y - b.y, a.z - b.z}; }
HD V3 vscale(V3 a, float s) { return V3{a.x * s, a.y * s, a.z * s}; }
HD V3 vneg(V3 a) { return V3{-a.x, -a.y, -a.z}; }
HD float vdot(V3 a, V3 b) { return a.x * b.x + a.y * b.y + a.z * b.z; }
HD V3 vsel(bool m, V3 a, V3 b) { return m ? a : b; }
HD V3 vnormalize(V3 a) { return vscale(a, rsqrtf(fmaxf(vdot(a, a), 1e-24f))); }
HD float safe_sqrt(float x) { return sqrtf(fmaxf(x, 0.0f)); }
HD float clampf(float x, float lo, float hi) { return fminf(fmaxf(x, lo), hi); }
HD V3 load3(const float* p) { return V3{p[0], p[1], p[2]}; }

// Duff et al. branchless ONB (core/math.make_frame)
HD void onb(V3 n, V3& s, V3& t) {
  float sign = n.z >= 0.0f ? 1.0f : -1.0f;
  float a = -1.0f / (sign + n.z);
  float b = n.x * n.y * a;
  s = V3{1.0f + sign * n.x * n.x * a, sign * b, -sign * n.x};
  t = V3{b, sign + n.y * n.y * a, -n.y};
}

HD V3 to_local(V3 s, V3 t, V3 n, V3 w) { return V3{vdot(s, w), vdot(t, w), vdot(n, w)}; }

HD V3 to_world(V3 s, V3 t, V3 n, V3 l) {
  return V3{s.x * l.x + t.x * l.y + n.x * l.z, s.y * l.x + t.y * l.y + n.y * l.z,
            s.z * l.x + t.z * l.y + n.z * l.z};
}

// common.h:275 fresnel(), both sides
HD float fresnel_dielectric(float cos_i, float ext_ior, float int_ior) {
  float ei = cos_i >= 0.0f ? ext_ior : int_ior;
  float et = cos_i >= 0.0f ? int_ior : ext_ior;
  float ci = fabsf(cos_i);
  float eta = ei / et;
  float sin_t2 = eta * eta * fmaxf(1.0f - ci * ci, 0.0f);
  float ct = safe_sqrt(1.0f - sin_t2);
  float rs = (ei * ci - et * ct) / fmaxf(fabsf(ei * ci + et * ct), 1e-12f);
  float rp = (et * ci - ei * ct) / fmaxf(fabsf(et * ci + ei * ct), 1e-12f);
  float f = 0.5f * (rs * rs + rp * rp);
  return sin_t2 >= 1.0f ? 1.0f : f;
}

// ---------------------------------------------------------------------------
// pcg32 (pcg32.h) and tea (cuda/sutil/random.h:34-47)
// ---------------------------------------------------------------------------

constexpr uint64_t PCG32_MULT = 0x5851f42d4c957f2dULL;

struct Pcg32 {
  uint64_t state, inc;
};

HD Pcg32 pcg32_seed(uint64_t initstate, uint64_t initseq) {
  Pcg32 p;
  p.state = 0u;
  p.inc = (initseq << 1u) | 1u;
  p.state = p.state * PCG32_MULT + p.inc;
  p.state += initstate;
  p.state = p.state * PCG32_MULT + p.inc;
  return p;
}

HD uint32_t pcg32_next_uint(Pcg32& p) {
  uint64_t old = p.state;
  p.state = old * PCG32_MULT + p.inc;
  uint32_t xorshifted = (uint32_t)(((old >> 18u) ^ old) >> 27u);
  uint32_t rot = (uint32_t)(old >> 59u);
  return (xorshifted >> rot) | (xorshifted << ((~rot + 1u) & 31u));
}

HD float bits_to_float(uint32_t b) {
#ifdef __CUDA_ARCH__
  return __uint_as_float(b);
#else
  float f;
  memcpy(&f, &b, 4);
  return f;
#endif
}

HD float draw1(Pcg32& p) {
  return bits_to_float((pcg32_next_uint(p) >> 9u) | 0x3F800000u) - 1.0f;
}

HD uint32_t tea4(uint32_t v0, uint32_t v1) {
  uint32_t s0 = 0u;
  for (int n = 0; n < 4; ++n) {
    s0 += 0x9E3779B9u;
    v0 += ((v1 << 4u) + 0xA341316Cu) ^ (v1 + s0) ^ ((v1 >> 5u) + 0xC8013EA4u);
    v1 += ((v0 << 4u) + 0xAD90777Du) ^ (v0 + s0) ^ ((v0 >> 5u) + 0x7E95761Eu);
  }
  return v0;
}

// ---------------------------------------------------------------------------
// triangles, spheres and per-id table reads
// ---------------------------------------------------------------------------

// Moller-Trumbore (mesh.cpp:61-97); true and (u, v, t) when the test passes
HD bool mt_test(V3 v0, V3 e1, V3 e2, V3 o, V3 d, float& u, float& v, float& t) {
  V3 pv{d.y * e2.z - d.z * e2.y, d.z * e2.x - d.x * e2.z, d.x * e2.y - d.y * e2.x};
  float det = e1.x * pv.x + e1.y * pv.y + e1.z * pv.z;
  bool det_ok = fabsf(det) > 1e-12f;
  float inv = 1.0f / (det_ok ? det : 1e-12f);
  V3 tv = vsub(o, v0);
  u = (tv.x * pv.x + tv.y * pv.y + tv.z * pv.z) * inv;
  V3 qv{tv.y * e1.z - tv.z * e1.y, tv.z * e1.x - tv.x * e1.z, tv.x * e1.y - tv.y * e1.x};
  v = (d.x * qv.x + d.y * qv.y + d.z * qv.z) * inv;
  t = (e2.x * qv.x + e2.y * qv.y + e2.z * qv.z) * inv;
  return det_ok && u >= 0.0f && v >= 0.0f && u + v <= 1.0f;
}

// the same test on a triangle row that starts v0 | e1 | e2
HD bool mt_hit(const float* tr, V3 o, V3 d, float& u, float& v, float& t) {
  return mt_test(load3(tr), load3(tr + 3), load3(tr + 6), o, d, u, v, t);
}

// Stable-quadratic sphere test (sphere.cpp:67-124): closest t in [mint, cutoff),
// sid = -1 on a miss. Rows with radius <= 0 are padding.
HD float sphere_hit(const float* sph, int n_rows, V3 o, V3 d, float mint, float cutoff,
                    int& sid) {
  float best_t = cutoff;
  sid = -1;
  float a = vdot(d, d);
  for (int j = 0; j < n_rows; ++j) {
    const float* s = sph + j * SPH_COLS;
    float r = s[3];
    if (!(r > 0.0f)) continue;
    V3 oc = vsub(o, load3(s));
    float b = 2.0f * vdot(oc, d);
    float c = vdot(oc, oc) - r * r;
    float disc = b * b - 4.0f * a * c;
    bool ok = disc >= 0.0f;
    float sq = safe_sqrt(disc);
    float sgn = b > 0.0f ? 1.0f : (b < 0.0f ? -1.0f : 0.0f);
    float q = -0.5f * (b + sgn * sq);
    float t0 = q / a;
    float t1 = c / (fabsf(q) > 1e-20f ? q : 1e-20f);
    float tn = fminf(t0, t1), tf = fmaxf(t0, t1);
    bool in_n = ok && tn >= mint && tn < best_t;
    bool in_f = ok && tf >= mint && tf < best_t;
    float t_c = in_n ? tn : (in_f ? tf : BIG);
    if (t_c < best_t) {
      best_t = t_c;
      sid = j;
    }
  }
  return best_t;
}

// column c of row id of a [rows, cols] table; 0 for ids outside [0, rows)
HD float row_at(const float* tab, int cols, int rows, int id, int c) {
  return (id >= 0 && id < rows) ? tab[id * cols + c] : 0.0f;
}

// ---------------------------------------------------------------------------
// BSDFs (ops/bsdf.py semantics: diffuse.cpp, mirror.cpp,
// dielectric.cpp:52-102, microfacet.cpp:20-160, disney.cpp:111-199)
// ---------------------------------------------------------------------------

struct Bsdf {
  int type;
  float alpha, int_ior, ext_ior, ks;
  V3 kd, albedo;
  float disney[10];
};

HD V3 cosine_hemisphere(float u1, float u2) {
  float rho = sqrtf(fmaxf(u1, 0.0f));
  float th = u2 * TWO_PI;
  float x = rho * cosf(th);
  float y = rho * sinf(th);
  return V3{x, y, safe_sqrt(1.0f - (x * x + y * y))};
}

HD V3 beckmann_sample(float u1, float u2, float alpha) {
  float log_s = logf(fmaxf(1.0f - u1, 1e-38f));
  float tan2 = -alpha * alpha * log_s;
  float phi = u2 * TWO_PI;
  float ct = 1.0f / sqrtf(1.0f + tan2);
  float st = safe_sqrt(1.0f - ct * ct);
  return V3{st * cosf(phi), st * sinf(phi), ct};
}

HD float beckmann_d(V3 m, float alpha) {
  float ct = fmaxf(m.z, 1e-4f);
  float inv_ct2 = 1.0f / (ct * ct);
  float tan2 = fmaxf(1.0f - ct * ct, 0.0f) * inv_ct2;
  return expf(-tan2 / (alpha * alpha)) * inv_ct2 * inv_ct2 / (PI * alpha * alpha);
}

HD float smith_g1(V3 v, V3 m, float alpha) {
  float ct = v.z;
  float tan_t = safe_sqrt(1.0f - ct * ct) / (fabsf(ct) > 1e-8f ? ct : 1e-8f);
  float a = 1.0f / fmaxf(alpha * fabsf(tan_t), 1e-8f);
  float a2 = a * a;
  float approx = (3.535f * a + 2.181f * a2) / (1.0f + 2.276f * a + 2.577f * a2);
  float g = a >= 1.6f ? 1.0f : approx;
  g = fabsf(tan_t) < 1e-8f ? 1.0f : g;
  return vdot(m, v) * ct <= 0.0f ? 0.0f : g;
}

HD V3 microfacet_eval(const Bsdf& P, V3 wi, V3 wo) {
  V3 wh = vnormalize(vadd(wi, wo));
  float d = beckmann_d(wh, P.alpha);
  float f = fresnel_dielectric(vdot(wh, wi), P.ext_ior, P.int_ior);
  float g = smith_g1(wi, wh, P.alpha) * smith_g1(wo, wh, P.alpha);
  float denom = 4.0f * wi.z * wo.z;
  float spec = P.ks * d * f * g / (fabsf(denom) > 1e-12f ? denom : 1e-12f);
  if (!(wo.z > 0.0f)) return V3{0.0f, 0.0f, 0.0f};
  return V3{P.kd.x * INV_PI + spec, P.kd.y * INV_PI + spec, P.kd.z * INV_PI + spec};
}

HD float microfacet_pdf(const Bsdf& P, V3 wi, V3 wo) {
  V3 wh = vnormalize(vadd(wi, wo));
  float d = beckmann_d(wh, P.alpha);
  float dwh = vdot(wo, wh);
  float part1 = P.ks * d * wh.z / (fabsf(4.0f * dwh) > 1e-12f ? 4.0f * dwh : 1e-12f);
  float part2 = (1.0f - P.ks) * wo.z * INV_PI;
  return wo.z > 0.0f ? part1 + part2 : 0.0f;
}

HD float schlick_fresnel(float a) {
  float m = clampf(1.0f - a, 0.0f, 1.0f);
  float m2 = m * m;
  return m2 * m2 * m;
}

HD float smith_g_ggx_aniso(float ndotv, float vdotx, float vdoty, float ax, float ay) {
  return 1.0f / fmaxf(
      ndotv + sqrtf(vdotx * ax * vdotx * ax + vdoty * ay * vdoty * ay + ndotv * ndotv), 1e-8f);
}

HD float smith_g_ggx(float ndotv, float alpha_g) {
  float a = alpha_g * alpha_g;
  float b = ndotv * ndotv;
  return 1.0f / fmaxf(ndotv + sqrtf(a + b - a * b), 1e-8f);
}

HD V3 disney_eval(const Bsdf& P, V3 L, V3 V) {
  const float metallic = P.disney[0], subsurface = P.disney[1], specular = P.disney[2],
              roughness = P.disney[3], specular_tint = P.disney[4], anisotropic = P.disney[5],
              sheen = P.disney[6], sheen_tint = P.disney[7], clearcoat = P.disney[8],
              clearcoat_gloss = P.disney[9];
  float ndotl = L.z, ndotv = V.z;
  bool valid = ndotl >= EPS && ndotv >= EPS;
  V3 H = vnormalize(vadd(L, V));
  float ndoth = H.z;
  float ldoth = vdot(L, H);
  float alb[3] = {P.albedo.x, P.albedo.y, P.albedo.z};
  float cdlin[3], ctint[3], cspec0[3], csheen[3];
  for (int c = 0; c < 3; ++c) cdlin[c] = powf(fmaxf(alb[c], 1e-6f), 2.2f);
  float cdlum = 0.3f * cdlin[0] + 0.6f * cdlin[1] + 0.1f * cdlin[2];
  float inv_lum = 1.0f / fmaxf(cdlum, 1e-12f);
  for (int c = 0; c < 3; ++c) {
    ctint[c] = cdlum > 0.0f ? cdlin[c] * inv_lum : 1.0f;
    cspec0[c] = (specular * 0.08f * (1.0f + (ctint[c] - 1.0f) * specular_tint)) *
                    (1.0f - metallic) + cdlin[c] * metallic;
    csheen[c] = 1.0f + (ctint[c] - 1.0f) * sheen_tint;
  }
  float fl = schlick_fresnel(ndotl);
  float fv = schlick_fresnel(ndotv);
  float fd90 = 0.5f + 2.0f * ldoth * ldoth * roughness;
  float fd = (1.0f + (fd90 - 1.0f) * fl) * (1.0f + (fd90 - 1.0f) * fv);
  float fss90 = ldoth * ldoth * roughness;
  float fss = (1.0f + (fss90 - 1.0f) * fl) * (1.0f + (fss90 - 1.0f) * fv);
  float ss = 1.25f * (fss * (1.0f / fmaxf(ndotl + ndotv, 1e-8f) - 0.5f) + 0.5f);

  float aspect = sqrtf(1.0f - anisotropic * 0.9f);
  float ax = fmaxf(roughness * roughness / aspect, 0.001f);
  float ay = fmaxf(roughness * roughness * aspect, 0.001f);
  float hx = H.x / ax, hy = H.y / ay;
  float base = hx * hx + hy * hy + ndoth * ndoth;
  float ds = 1.0f / fmaxf(PI * ax * ay * (base * base), 1e-12f);
  float fh = schlick_fresnel(ldoth);
  float gs = smith_g_ggx_aniso(ndotl, L.x, L.y, ax, ay) *
             smith_g_ggx_aniso(ndotv, V.x, V.y, ax, ay);

  // GTR1 clearcoat lobe (disney.cpp: mix(0.1, 0.001, gloss))
  float a_cc = fmaxf(0.1f + (float)(0.001 - 0.1) * clearcoat_gloss, 1e-4f);
  float a2 = a_cc * a_cc;
  float t_cc = 1.0f + (a2 - 1.0f) * ndoth * ndoth;
  float dr = a_cc >= 1.0f ? INV_PI : (a2 - 1.0f) / (PI * logf(a2) * t_cc);
  float fr = 0.04f + 0.96f * fh;
  float gr = smith_g_ggx(ndotl, 0.25f) * smith_g_ggx(ndotv, 0.25f);

  float diff_mix = fd + (ss - fd) * subsurface;
  float fin[3];
  for (int c = 0; c < 3; ++c) {
    float fs = cspec0[c] + (1.0f - cspec0[c]) * fh;
    float fsheen = fh * sheen * csheen[c];
    fin[c] = (INV_PI * diff_mix * cdlin[c] + fsheen) * (1.0f - metallic) + gs * ds * fs +
             0.25f * clearcoat * gr * fr * dr;
  }
  float lum = fin[0] * 0.212671f + fin[1] * 0.715160f + fin[2] * 0.072169f;
  float inv_l = 1.0f / fmaxf(lum, 1e-12f);
  if (lum > 1.0f)
    for (int c = 0; c < 3; ++c) fin[c] = fin[c] * inv_l;
  if (!valid) return V3{0.0f, 0.0f, 0.0f};
  return V3{fin[0], fin[1], fin[2]};
}

// f(wi, wo) rgb under solid angle
HD V3 bsdf_eval(const Bsdf& P, V3 wi, V3 wo) {
  switch (P.type) {
    case BSDF_DIFFUSE:
      return (wi.z > 0.0f && wo.z > 0.0f) ? vscale(P.albedo, INV_PI) : V3{0.0f, 0.0f, 0.0f};
    case BSDF_MICROFACET:
      return microfacet_eval(P, wi, wo);
    case BSDF_DISNEY:
      return disney_eval(P, wi, wo);
    default:
      return V3{0.0f, 0.0f, 0.0f};
  }
}

HD float bsdf_pdf(const Bsdf& P, V3 wi, V3 wo) {
  if (P.type == BSDF_DIFFUSE || P.type == BSDF_DISNEY)
    return (wi.z > 0.0f && wo.z > 0.0f) ? INV_PI * wo.z : 0.0f;
  if (P.type == BSDF_MICROFACET) return microfacet_pdf(P, wi, wo);
  return 0.0f;
}

// Sample wo for wi (local frame); returns wo, sets weight, pdf, discrete.
HD V3 bsdf_sample(const Bsdf& P, V3 wi, float u1, float u2, V3& weight, float& pdf,
                  bool& discrete) {
  float cos_i = wi.z;
  discrete = P.type == BSDF_MIRROR || P.type == BSDF_DIELECTRIC;
  pdf = 0.0f;
  if (P.type == BSDF_MIRROR) {
    float w = cos_i > 0.0f ? 1.0f : 0.0f;
    weight = V3{w, w, w};
    return V3{-wi.x, -wi.y, wi.z};
  }
  if (P.type == BSDF_DIELECTRIC) {
    float fr = fresnel_dielectric(cos_i, P.ext_ior, P.int_ior);
    bool reflect = u1 < fr;
    bool entering = cos_i >= 0.0f;
    float eta = entering ? P.ext_ior / P.int_ior : P.int_ior / P.ext_ior;
    float nz = entering ? 1.0f : -1.0f;
    float wi_dot_n = wi.z * nz;
    float sq = safe_sqrt(1.0f - eta * eta * (1.0f - wi_dot_n * wi_dot_n));
    float w = reflect ? 1.0f : 1.0f / (eta * eta);
    weight = V3{w, w, w};
    if (reflect) return V3{-wi.x, -wi.y, wi.z};
    return V3{-eta * wi.x, -eta * wi.y, -eta * (wi.z - wi_dot_n * nz) - sq * nz};
  }
  if (P.type == BSDF_MICROFACET) {
    float ks = P.ks;
    V3 wo;
    if (u2 < ks) {
      V3 wh = beckmann_sample(u1, u2 / fmaxf(ks, 1e-8f), P.alpha);
      float dw = 2.0f * vdot(wi, wh);
      wo = V3{dw * wh.x - wi.x, dw * wh.y - wi.y, dw * wh.z - wi.z};
    } else {
      wo = cosine_hemisphere(u1, (u2 - ks) / fmaxf(1.0f - ks, 1e-8f));
    }
    V3 f = microfacet_eval(P, wi, wo);
    float p = microfacet_pdf(P, wi, wo);
    bool ok = wo.z > 0.0f && cos_i >= 0.0f && p > 1e-12f;
    float scale = ok ? wo.z / fmaxf(p, 1e-12f) : 0.0f;
    weight = vscale(f, scale);
    pdf = p;
    return wo;
  }
  // diffuse and disney: cosine hemisphere
  V3 wo = cosine_hemisphere(u1, u2);
  if (P.type == BSDF_DISNEY) {
    V3 f = disney_eval(P, wi, wo);
    float p_dis = INV_PI * fmaxf(wo.z, 0.0f);
    weight = (cos_i > 0.0f && p_dis >= EPS) ? vscale(f, PI) : V3{0.0f, 0.0f, 0.0f};
  } else {
    weight = cos_i > 0.0f ? P.albedo : V3{0.0f, 0.0f, 0.0f};
  }
  pdf = cos_i > 0.0f ? INV_PI * fmaxf(wo.z, 0.0f) : 0.0f;
  return wo;
}

#ifdef __CUDACC__
// ---------------------------------------------------------------------------
// TMA bulk copies into shared memory: the shared-window address of a
// pointer, and a wait on an mbarrier phase
// ---------------------------------------------------------------------------

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return (uint32_t)__cvta_generic_to_shared(p);
}

__device__ __forceinline__ void mbar_wait(uint32_t bar, uint32_t parity) {
  uint32_t done = 0;
  do {
    asm volatile(
        "{\n"
        ".reg .pred p;\n"
        "mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n"
        "selp.u32 %0, 1, 0, p;\n"
        "}\n"
        : "=r"(done)
        : "r"(bar), "r"(parity)
        : "memory");
  } while (!done);
}
#endif

}  // namespace pk
