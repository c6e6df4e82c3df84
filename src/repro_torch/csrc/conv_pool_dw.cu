// K3: fused depthwise conv + bias + activation + max/avg pool, f32 or bf16.
//
// Replaces the TPU kernel repro/kernels/conv_pool/depthwise.py::_kernel_dw
// (built by conv_pool_call, pallas_call at kernel.py:230; NCHW entry point
// fused_depthwise_conv_pool at depthwise.py:125).  Same function: one
// kh x kw filter per channel (groups = C, weights (C, 1, kh, kw)), per-axis
// stride and padding, bias, optional ReLU, then a max or average pool with
// per-axis window and stride; pool 1x1 stride 1 is the identity, which is how
// the un-pooled depthwise+ReLU blocks of DS-CNN and MobileNet run.  The
// conv map is never stored: each pooled value is reduced in registers.
//
// What bounds it on an H100: there is no contraction, so each output reads
// kh*kw inputs and does as many multiply-adds; the bytes (input read once,
// output written once) dominate the operations.  At the main path's shapes
// (DS-CNN-KWS 64x25x5, MobileNet-V1 0.25 from 8x32x32 down to 256x2x2; at
// most 16 images) a call moves at most ~2 MB, about half a microsecond at
// 3.35 TB/s, so latency bounds it: how many dependent trips to memory a
// thread makes, and how much of the card one call reaches.  f32 on the
// CUDA cores; tensor cores do not apply.
//
// Design, for latency:
// * one output a thread, over a grid of (tile of pooled rows, image, tile of
//   channels) that depthwise.py::k3_tiling sizes to reach one CTA per SM of
//   the card (132) where the call has a warp of outputs for each, so one
//   image of DS-CNN-KWS's 64 x 25 x 5 runs on 256 CTAs, not 25;
// * neighbouring threads take neighbouring pooled columns of one channel,
//   so their input loads fall on neighbouring addresses;
// * each thread reads its channel's taps straight from device memory (the
//   threads of a channel read the same addresses, one broadcast each): no
//   staging of every channel's taps behind a barrier before the first
//   input load;
// * the 3x3 filter of every depthwise step of both nets is a template case
//   in which the 9 taps and the 9 inputs of a conv value are unrolled, the
//   zero padding a predicate on each input load (not a branch around it),
//   so all 18 loads are in flight together: one round trip to memory before
//   the arithmetic, not one per tap; other filter shapes keep a loop over
//   their taps;
// * each conv value sums its taps row-major from zero by fmaf, then adds the
//   bias, applies the activation and folds into the pool window: a padding
//   tap adds fmaf(0, w, s) = s, so each value is the earlier design's, which
//   skipped those taps;
// * input and output are batch-strided NCHW, so a step reads one arena
//   buffer and writes another in place.
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>

#include "conv_pool_math.cuh"

namespace {

__device__ __forceinline__ float ld_f32(const float* p) { return __ldg(p); }
__device__ __forceinline__ float ld_f32(const __nv_bfloat16* p) {
  return __bfloat162float(__ushort_as_bfloat16(__ldg(reinterpret_cast<const unsigned short*>(p))));
}

template <typename T> __device__ __forceinline__ T from_f32(float v);
template <> __device__ __forceinline__ float from_f32<float>(float v) { return v; }
template <> __device__ __forceinline__ __nv_bfloat16 from_f32<__nv_bfloat16>(float v) {
  return __float2bfloat16_rn(v);
}

// One conv value at conv position (oh, ow) of channel plane xc: its taps
// summed row-major from zero.  K = 3 unrolls a 3x3 filter (taps in wr);
// K = 0 walks g.kh x g.kw taps read from wc.
template <int K, typename T>
__device__ __forceinline__ float conv_value(const T* __restrict__ xc,
                                            const T* __restrict__ wc, const float* wr,
                                            const cp::Geom& g, int oh, int ow) {
  const int ih0 = cp::in_origin(oh, g.csh, g.padh);
  const int iw0 = cp::in_origin(ow, g.csw, g.padw);
  float s = 0.0f;
  if (K == 3) {
    float v[9];
#pragma unroll
    for (int dz = 0; dz < 3; ++dz) {
#pragma unroll
      for (int dt = 0; dt < 3; ++dt) {
        const int ih = ih0 + dz, iw = iw0 + dt;
        const bool ok = cp::in_bounds(ih, g.h) && cp::in_bounds(iw, g.w);
        v[dz * 3 + dt] = ok ? ld_f32(xc + ih * g.w + iw) : 0.0f;
      }
    }
#pragma unroll
    for (int q = 0; q < 9; ++q) s = fmaf(v[q], wr[q], s);
  } else {
    for (int dz = 0; dz < g.kh; ++dz) {
      const int ih = ih0 + dz;
      for (int dt = 0; dt < g.kw; ++dt) {
        const int iw = iw0 + dt;
        const bool ok = cp::in_bounds(ih, g.h) && cp::in_bounds(iw, g.w);
        s = fmaf(ok ? ld_f32(xc + ih * g.w + iw) : 0.0f, ld_f32(wc + dz * g.kw + dt), s);
      }
    }
  }
  return s;
}

template <typename T, int K>
__global__ void __launch_bounds__(256)
conv_pool_dw_kernel(const T* __restrict__ x, const T* __restrict__ w,
                    const T* __restrict__ b, T* __restrict__ y, cp::Geom g,
                    long long x_bstride, long long y_bstride, int rows_per_cta,
                    int c_tile, int relu, int avg) {
  const int c0 = blockIdx.z * c_tile;
  const int ct = min(c_tile, g.cout - c0);
  const int pr0 = blockIdx.x * rows_per_cta;
  const int rows = min(rows_per_cta, g.ph - pr0);
  const int img = blockIdx.y;
  const T* xi = x + img * x_bstride;
  T* yi = y + img * y_bstride;
  const int plane = g.h * g.w;
  const float identity = avg ? 0.0f : -INFINITY;

  for (int e = threadIdx.x; e < ct * rows * g.pw; e += blockDim.x) {
    const int pc = e % g.pw, rest = e / g.pw;
    const int pr = pr0 + rest % rows, c = c0 + rest / rows;
    const T* xc = xi + static_cast<long long>(c) * plane;
    const T* wc = w + c * g.kh * g.kw;
    float wr[9];
    if (K == 3) {
#pragma unroll
      for (int q = 0; q < 9; ++q) wr[q] = ld_f32(wc + q);
    }
    const float bias = b ? ld_f32(b + c) : 0.0f;
    float red = identity;
    for (int i = 0; i < g.pkh; ++i) {
      const int oh = cp::conv_pos(pr, g.psh, i);
      for (int j = 0; j < g.pkw; ++j) {
        float s = conv_value<K>(xc, wc, wr, g, oh, cp::conv_pos(pc, g.psw, j));
        s += bias;
        if (relu) s = fmaxf(s, 0.0f);
        red = avg ? red + s : fmaxf(red, s);
      }
    }
    if (avg) red = __fdiv_rn(red, static_cast<float>(g.pkh * g.pkw));
    yi[(static_cast<long long>(c) * g.ph + pr) * g.pw + pc] = from_f32<T>(red);
  }
}

template <typename T>
int launch(const void* x, const void* w, const void* b, void* y, int n, int cin,
           int h, int w_, int cout, int kh, int kw, int csh, int csw, int padh,
           int padw, int pkh, int pkw, int psh, int psw, int relu, int avg,
           int rows_per_cta, int c_tile, long long x_bstride, long long y_bstride,
           void* stream) {
  if (rows_per_cta < 1 || c_tile < 1) return static_cast<int>(cudaErrorInvalidValue);
  const cp::Geom g = cp::make_geom(n, cin, h, w_, cout, kh, kw, csh, csw, padh,
                                   padw, pkh, pkw, psh, psw);
  const long long work = static_cast<long long>(rows_per_cta) * c_tile * g.pw;
  const int threads = static_cast<int>(work < 256 ? (work + 31) / 32 * 32 : 256);
  const dim3 grid((g.ph + rows_per_cta - 1) / rows_per_cta, n,
                  (cout + c_tile - 1) / c_tile);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const T* xt = static_cast<const T*>(x);
  const T* wt = static_cast<const T*>(w);
  const T* bt = static_cast<const T*>(b);
  T* yt = static_cast<T*>(y);
  if (kh == 3 && kw == 3)
    conv_pool_dw_kernel<T, 3><<<grid, threads, 0, s>>>(xt, wt, bt, yt, g, x_bstride,
                                                      y_bstride, rows_per_cta, c_tile,
                                                      relu, avg);
  else
    conv_pool_dw_kernel<T, 0><<<grid, threads, 0, s>>>(xt, wt, bt, yt, g, x_bstride,
                                                      y_bstride, rows_per_cta, c_tile,
                                                      relu, avg);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

extern "C" int conv_pool_dw_f32(const void* x, const void* w, const void* b, void* y,
                                int n, int cin, int h, int w_, int cout, int kh, int kw,
                                int csh, int csw, int padh, int padw, int pkh, int pkw,
                                int psh, int psw, int relu, int avg, int rows_per_cta,
                                int c_tile, long long x_bstride, long long y_bstride,
                                void* stream) {
  return launch<float>(x, w, b, y, n, cin, h, w_, cout, kh, kw, csh, csw, padh, padw,
                       pkh, pkw, psh, psw, relu, avg, rows_per_cta, c_tile, x_bstride,
                       y_bstride, stream);
}

extern "C" int conv_pool_dw_bf16(const void* x, const void* w, const void* b, void* y,
                                 int n, int cin, int h, int w_, int cout, int kh, int kw,
                                 int csh, int csw, int padh, int padw, int pkh, int pkw,
                                 int psh, int psw, int relu, int avg, int rows_per_cta,
                                 int c_tile, long long x_bstride, long long y_bstride,
                                 void* stream) {
  return launch<__nv_bfloat16>(x, w, b, y, n, cin, h, w_, cout, kh, kw, csh, csw, padh,
                               padw, pkh, pkw, psh, psw, relu, avg, rows_per_cta, c_tile,
                               x_bstride, y_bstride, stream);
}
