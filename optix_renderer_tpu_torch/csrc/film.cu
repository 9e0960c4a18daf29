// The scan path's filter splat for Hopper (sm_90a): a round's samples added
// into the weighted film [K, H, W, 4] (rgb * w, w) in one launch.
//
// It replaces no Pallas kernel: the JAX package splats with an XLA scatter
// (`film.splat`, `.at[].add`), which the port first wrote as one
// `index_put_(accumulate=True)` a filter tap (render/film.py:
// _splat_plain_, the plain version and the contract). On the card that call
// sorts its 3 x N indices (a radix sort), concatenates its values and walks
// the sorted runs, 16 times a round under the gaussian filter: ~7 ms a
// round of 480,000 lanes, where the bytes need ~0.02 ms.
//
// What bounds it: per lane its position (8 B) and K layer values (12 B
// each) read once, and the film read and written once (23 MB at 800x600,
// K = 3), which sits in the 50 MB L2 while the adds land. The design:
//   - one thread per lane, in 256-thread blocks; on the scan path
//     neighbouring lanes are neighbouring pixels, so each tap's adds from a
//     warp fall on contiguous 16-byte pixels;
//   - separable weights: `support` x weights and `support` y weights once a
//     lane (8 filter evaluations under the gaussian, not 32), each tap's
//     weight their product, as the plain body forms it;
//   - one vector reduction (atomicAdd on a float4, sm_90's
//     red.global.add.v4.f32) a layer a tap inside the image with a nonzero
//     weight: no sort, no intermediate tensor.
// The formulas are the plain body's in its order of operations (the filter
// constants are its Python doubles rounded to float32), built without FMA
// contraction (ops/cuda/_build.py), so each added value is the plain body's.
// Colliding samples add in an order that varies from run to run, as the
// accumulating index_put_ adds on a card: a film differs from run to run in
// its last bits, never in which samples it holds.
//
// A masked-off lane, a tap outside the image and a lane whose footprint
// misses the image (the scan path's padding lanes, far outside) add
// nothing.
//
// splat_grad_kernel is the splat's adjoint, the backward of a film that
// autograd follows on a card (render/film.py: splat): one thread per lane,
// the same taps and weights, each layer's gradient the sum over its taps of
// the film gradient's rgb times the tap's weight (the weight channel holds
// no layer), written once a lane into zeros, with no atomics.
//
// The lane bodies are HD, so they also compile with a host compiler
// (film_splat_host below, lane after lane), which the tests build with g++
// and hold against the plain body and its autograd on the CPU.

#ifdef __CUDACC__
#include <cuda_runtime.h>
#define HD __device__ __forceinline__
#else
#include <math.h>
#include <stddef.h>
#define HD inline
#endif

namespace film {

constexpr int THREADS = 256;

// render/film.py's filters; the codes of ops/cuda/film.py: FILTER_CODE
enum { BOX = 0, TENT = 1, GAUSSIAN = 2, MITCHELL = 3 };

// the gaussian's alpha = -1 / (2 * 0.5^2) and its value at the radius,
// exp(alpha * 2^2), as float32
constexpr float G_ALPHA = -2.0f;
constexpr float G_CUT = 0x1.5fc21p-12f;
// Mitchell-Netravali, B = C = 1/3: the inner and outer cubics' coefficients
// (12 - 9B - 6C, -18 + 12B + 6C, 6 - 2B; -B - 6C, 6B + 30C, -12B - 48C,
// 8B + 24C) and 1/6, each the float32 of the plain body's double
constexpr float M_I3 = 7.0f;
constexpr float M_I2 = -12.0f;
constexpr float M_I0 = 0x1.555556p+2f;
constexpr float M_O3 = -0x1.2aaaaap+1f;
constexpr float M_O2 = 12.0f;
constexpr float M_O1 = -20.0f;
constexpr float M_O0 = 0x1.555556p+3f;
constexpr float SIXTH = 0x1.555556p-3f;

template <int F>
struct Filter;
template <>
struct Filter<BOX> {
  static constexpr float RADIUS = 0.5f;
  static constexpr int SUPPORT = 1;
};
template <>
struct Filter<TENT> {
  static constexpr float RADIUS = 1.0f;
  static constexpr int SUPPORT = 2;
};
template <>
struct Filter<GAUSSIAN> {
  static constexpr float RADIUS = 2.0f;
  static constexpr int SUPPORT = 4;
};
template <>
struct Filter<MITCHELL> {
  static constexpr float RADIUS = 2.0f;
  static constexpr int SUPPORT = 4;
};

// torch.clamp(v, min=0): a -0.0 or a NaN passes
HD float clamp0(float v) { return v < 0.0f ? 0.0f : v; }

// render/film.py: _filter_eval, operation for operation
template <int F>
HD float filter_eval(float x) {
  const float ax = fabsf(x);
  if (F == GAUSSIAN) return clamp0(expf((G_ALPHA * ax) * ax) - G_CUT);
  if (F == MITCHELL) {
    const float x2 = ax * ax;
    const float x3 = x2 * ax;
    const float inner = ((M_I3 * x3 + M_I2 * x2) + M_I0) * SIXTH;
    const float outer = (((M_O3 * x3 + M_O2 * x2) + M_O1 * ax) + M_O0) * SIXTH;
    return ax < 1.0f ? inner : (ax < 2.0f ? outer : 0.0f);
  }
  if (F == TENT) return clamp0(1.0f - ax);
  return ax <= 0.5f ? 1.0f : 0.0f;
}

struct Film {
  float* img;                  // [k, h, w, 4], 16-byte aligned: the film, or its gradient
  const float* pos;            // [n, 2]
  float* layers;               // [k, n, 3]: read by the splat, written by its adjoint
  const unsigned char* mask;   // [n] bool, or null
  int k, h, w, n;
};

// Lane i's footprint: its first pixel and its x and y filter weights.
template <int F>
struct Taps {
  static constexpr int S = Filter<F>::SUPPORT;
  int x0, y0;
  float wx[S], wy[S];

  // false where the lane is masked off or no tap lands in the image
  HD bool init(const Film& A, int i) {
    constexpr float R = Filter<F>::RADIUS;
    if (A.mask != nullptr && !A.mask[i]) return false;
    const float px = A.pos[2 * i] - 0.5f;
    const float py = A.pos[2 * i + 1] - 0.5f;
    const float fx0 = floorf((px - R) + 1.0f);
    const float fy0 = floorf((py - R) + 1.0f);
    // a NaN fails the tests too
    if (!(fx0 > (float)-S && fx0 < (float)A.w && fy0 > (float)-S && fy0 < (float)A.h))
      return false;
    x0 = (int)fx0;
    y0 = (int)fy0;
#pragma unroll
    for (int d = 0; d < S; ++d) {
      wx[d] = filter_eval<F>(px - (float)(x0 + d));
      wy[d] = filter_eval<F>(py - (float)(y0 + d));
    }
    return true;
  }

  // `fn(pixel, w)` for each tap inside the image with a nonzero weight, in
  // row order; `pixel` indexes an [h, w] plane
  template <class Fn>
  HD void each(const Film& A, const Fn& fn) const {
#pragma unroll
    for (int dy = 0; dy < S; ++dy) {
      const int iy = y0 + dy;
      if (iy < 0 || iy >= A.h) continue;
#pragma unroll
      for (int dx = 0; dx < S; ++dx) {
        const int ix = x0 + dx;
        const float w = wx[dx] * wy[dy];
        if (ix < 0 || ix >= A.w || w == 0.0f) continue;
        fn((size_t)iy * A.w + ix, w);
      }
    }
  }
};

// Lane i's taps, each added by `add(pixel, r * w, g * w, b * w, w)`.
template <int F, class Add>
HD void splat_lane(const Film& A, int i, const Add& add) {
  Taps<F> t;
  if (!t.init(A, i)) return;
  for (int c = 0; c < A.k; ++c) {
    const float* l = A.layers + ((size_t)c * A.n + i) * 3;
    const float r = l[0], g = l[1], b = l[2];
    float* plane = A.img + (size_t)c * A.h * A.w * 4;
    t.each(A, [&](size_t p, float w) { add(plane + p * 4, r * w, g * w, b * w, w); });
  }
}

// Lane i's layer gradients from the film's gradient in A.img; a lane that
// adds nothing is left as it is (zeros).
template <int F>
HD void splat_grad_lane(const Film& A, int i) {
  Taps<F> t;
  if (!t.init(A, i)) return;
  for (int c = 0; c < A.k; ++c) {
    const float* plane = A.img + (size_t)c * A.h * A.w * 4;
    float r = 0.0f, g = 0.0f, b = 0.0f;
    t.each(A, [&](size_t p, float w) {
      r += plane[p * 4] * w;
      g += plane[p * 4 + 1] * w;
      b += plane[p * 4 + 2] * w;
    });
    float* l = A.layers + ((size_t)c * A.n + i) * 3;
    l[0] = r;
    l[1] = g;
    l[2] = b;
  }
}

}  // namespace film

#ifdef __CUDACC__

namespace film {

struct DeviceAdd {
  HD void operator()(float* p, float r, float g, float b, float w) const {
    atomicAdd(reinterpret_cast<float4*>(p), make_float4(r, g, b, w));
  }
};

template <int F>
__global__ void __launch_bounds__(THREADS) splat_kernel(const Film A) {
  const int i = blockIdx.x * blockDim.x + threadIdx.x;
  if (i < A.n) splat_lane<F>(A, i, DeviceAdd{});
}

template <int F>
__global__ void __launch_bounds__(THREADS) splat_grad_kernel(const Film A) {
  const int i = blockIdx.x * blockDim.x + threadIdx.x;
  if (i < A.n) splat_grad_lane<F>(A, i);
}

template <int F>
void launch(const Film& A, bool grad, cudaStream_t s) {
  const int blocks = (A.n + THREADS - 1) / THREADS;
  if (grad)
    splat_grad_kernel<F><<<blocks, THREADS, 0, s>>>(A);
  else
    splat_kernel<F><<<blocks, THREADS, 0, s>>>(A);
}

}  // namespace film

// One launch over the n lanes on `stream`: with grad = 0 the splat of
// `layers` into `img`, with grad = 1 its adjoint, `img` the film's gradient
// and `layers` written. Returns the launch's cudaError.
extern "C" int film_splat_launch(float* img, const float* pos, float* layers,
                                 const unsigned char* mask, int k, int h, int w, int n,
                                 int filter, int grad, void* stream) {
  if (img == nullptr || pos == nullptr || layers == nullptr || k <= 0 || h <= 0 || w <= 0 ||
      n <= 0)
    return (int)cudaErrorInvalidValue;
  const film::Film A{img, pos, layers, mask, k, h, w, n};
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (filter) {
    case film::BOX: film::launch<film::BOX>(A, grad != 0, s); break;
    case film::TENT: film::launch<film::TENT>(A, grad != 0, s); break;
    case film::GAUSSIAN: film::launch<film::GAUSSIAN>(A, grad != 0, s); break;
    case film::MITCHELL: film::launch<film::MITCHELL>(A, grad != 0, s); break;
    default: return (int)cudaErrorInvalidValue;
  }
  return (int)cudaGetLastError();
}

#else

namespace film {

struct HostAdd {
  void operator()(float* p, float r, float g, float b, float w) const {
    p[0] += r;
    p[1] += g;
    p[2] += b;
    p[3] += w;
  }
};

template <int F>
void run_host(const Film& A, bool grad) {
  for (int i = 0; i < A.n; ++i) {
    if (grad)
      splat_grad_lane<F>(A, i);
    else
      splat_lane<F>(A, i, HostAdd{});
  }
}

}  // namespace film

// film_splat_launch on the host, lane after lane (the tests' g++ build);
// returns 0, or -1 for an unknown filter.
extern "C" int film_splat_host(float* img, const float* pos, float* layers,
                               const unsigned char* mask, int k, int h, int w, int n,
                               int filter, int grad) {
  const film::Film A{img, pos, layers, mask, k, h, w, n};
  switch (filter) {
    case film::BOX: film::run_host<film::BOX>(A, grad != 0); return 0;
    case film::TENT: film::run_host<film::TENT>(A, grad != 0); return 0;
    case film::GAUSSIAN: film::run_host<film::GAUSSIAN>(A, grad != 0); return 0;
    case film::MITCHELL: film::run_host<film::MITCHELL>(A, grad != 0); return 0;
    default: return -1;
  }
}

#endif  // __CUDACC__
