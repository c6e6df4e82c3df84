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
// 3.35 TB/s, so a launch bounds it.  f32 on the CUDA cores; tensor cores do
// not apply.
//
// Design, simple first, the grid of K1 (conv_pool.cu) without the reduction
// over input channels:
// * one CTA per (tile of pooled rows, image, tile of channels); the kh*kw
//   taps of its channels are staged in shared memory as f32 (9 KB for 256
//   channels of 3x3);
// * one thread per (channel, pooled column) walks the pooled rows of the
//   tile; neighbouring threads take neighbouring columns of one channel, so
//   their loads fall on neighbouring addresses;
// * padding is bounds-checked zero taps; input and output are batch-strided
//   NCHW, so a step reads one arena buffer and writes another in place.
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>

#include "conv_pool_math.cuh"

namespace {

__device__ __forceinline__ float to_f32(float v) { return v; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 v) { return __bfloat162float(v); }

template <typename T> __device__ __forceinline__ T from_f32(float v);
template <> __device__ __forceinline__ float from_f32<float>(float v) { return v; }
template <> __device__ __forceinline__ __nv_bfloat16 from_f32<__nv_bfloat16>(float v) {
  return __float2bfloat16_rn(v);
}

template <typename T>
__global__ void conv_pool_dw_kernel(const T* __restrict__ x, const T* __restrict__ w,
                                    const T* __restrict__ b, T* __restrict__ y,
                                    cp::Geom g, long long x_bstride, long long y_bstride,
                                    int rows_per_cta, int c_tile, int relu, int avg) {
  extern __shared__ float w_s[];  // (channels of this tile, kh, kw) as f32
  const int taps = g.kh * g.kw;
  const int c0 = blockIdx.z * c_tile;
  const int ct = min(c_tile, g.cout - c0);
  const T* wt = w + static_cast<long long>(c0) * taps;
  for (int i = threadIdx.x; i < ct * taps; i += blockDim.x) w_s[i] = to_f32(wt[i]);
  __syncthreads();

  const int img = blockIdx.y;
  const int pr0 = blockIdx.x * rows_per_cta;
  const T* xi = x + img * x_bstride;
  T* yi = y + img * y_bstride;
  const int plane = g.h * g.w;
  const int work = rows_per_cta * ct * g.pw;
  const float identity = avg ? 0.0f : -INFINITY;

  for (int t = threadIdx.x; t < work; t += blockDim.x) {
    const int pc = t % g.pw;
    const int rest = t / g.pw;
    const int cl = rest % ct;
    const int c = c0 + cl;
    const int pr = pr0 + rest / ct;
    if (pr >= g.ph) continue;
    const float bias = b ? to_f32(b[c]) : 0.0f;
    const T* xc = xi + static_cast<long long>(c) * plane;
    const float* wc = w_s + cl * taps;
    float red = identity;
    for (int i = 0; i < g.pkh; ++i) {
      const int ih0 = cp::in_origin(cp::conv_pos(pr, g.psh, i), g.csh, g.padh);
      for (int j = 0; j < g.pkw; ++j) {
        const int iw0 = cp::in_origin(cp::conv_pos(pc, g.psw, j), g.csw, g.padw);
        float s = 0.0f;
        for (int dz = 0; dz < g.kh; ++dz) {
          const int ih = ih0 + dz;
          if (!cp::in_bounds(ih, g.h)) continue;
          for (int dt = 0; dt < g.kw; ++dt) {
            const int iw = iw0 + dt;
            if (!cp::in_bounds(iw, g.w)) continue;
            s += to_f32(xc[ih * g.w + iw]) * wc[dz * g.kw + dt];
          }
        }
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
  const cp::Geom g = cp::make_geom(n, cin, h, w_, cout, kh, kw, csh, csw, padh,
                                   padw, pkh, pkw, psh, psw);
  const size_t smem = sizeof(float) * static_cast<size_t>(c_tile) * kh * kw;
  if (smem > 48 * 1024) {
    cudaError_t e = cudaFuncSetAttribute(conv_pool_dw_kernel<T>,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize,
                                         static_cast<int>(smem));
    if (e != cudaSuccess) return static_cast<int>(e);
  }
  const int work = rows_per_cta * c_tile * g.pw;
  int threads = ((work + 31) / 32) * 32;
  if (threads > 256) threads = 256;
  const dim3 grid((g.ph + rows_per_cta - 1) / rows_per_cta, n,
                  (cout + c_tile - 1) / c_tile);
  conv_pool_dw_kernel<T><<<grid, threads, smem, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const T*>(x), static_cast<const T*>(w), static_cast<const T*>(b),
      static_cast<T*>(y), g, x_bstride, y_bstride, rows_per_cta, c_tile, relu, avg);
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
