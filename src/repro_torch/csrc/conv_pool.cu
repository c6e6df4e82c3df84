// K1: fused dense conv + bias + activation + max/avg pool, f32 or bf16.
//
// Replaces the TPU kernel repro/kernels/conv_pool/kernel.py::_kernel (built
// by conv_pool_call, pallas_call at kernel.py:230; NCHW wrapper
// ops.fused_conv_pool at ops.py:57).  Same function: a dense conv over an
// NCHW input with per-axis kernel/stride/padding, bias, optional ReLU, then
// a max or average pool with per-axis window and stride.  The conv map is
// never stored: each pooled value is reduced in registers from the conv
// values its window needs.
//
// What bounds it on an H100: at the paper's shapes (LeNet-5 conv1 1->6 at
// 32x32, conv2 6->16 at 14x14; at most 16 images) the work is a few MFLOP
// and a few hundred KB, which the card moves in well under a microsecond,
// so a launch (a few microseconds) bounds it.  Of the two roofline terms
// the operations dominate: f32 on the CUDA cores (67 TFLOP/s), no tensor
// cores, since TF32 would break the reference's 1e-5 tolerance.
//
// Design, simple first:
// * one CTA per (tile of pooled rows, image, tile of output channels); the
//   weights of its channel tile are staged once per CTA in shared memory, as
//   f32.  The host picks the channel tile so that they fit in 227 KB
//   (kernel.py::cout_tile): all channels in one tile for the paper's layers
//   (9.6 KB for LeNet conv2), two tiles of 128 for MobileNet's 256->256
//   head (256 KB of f32 weights in all);
// * one thread per (out channel, pooled column) walks the pooled rows of the
//   tile; for each it accumulates in f32 over the conv positions its pool
//   window needs, adds the bias, applies the ReLU and takes the max or sum
//   in registers, then writes one value;
// * the input is read straight from NCHW with a batch stride, and the output
//   written with one, so a step can read from and write into the two banks
//   of the ping-pong arena without copies;
// * padding is bounds-checked zero taps, not a padded copy of the input.
// Shared-memory halo tiles and tensor-core (wgmma) formulations are later
// work.
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
__global__ void conv_pool_kernel(const T* __restrict__ x, const T* __restrict__ w,
                                 const T* __restrict__ b, T* __restrict__ y,
                                 cp::Geom g, long long x_bstride, long long y_bstride,
                                 int rows_per_cta, int cout_tile, int relu, int avg) {
  extern __shared__ float w_s[];  // (channels of this tile, cin, kh, kw) as f32
  const int taps = g.kh * g.kw;
  const int co0 = blockIdx.z * cout_tile;
  const int ct = min(cout_tile, g.cout - co0);
  const int n_w = ct * g.cin * taps;
  const T* wt = w + static_cast<long long>(co0) * g.cin * taps;
  for (int i = threadIdx.x; i < n_w; i += blockDim.x) w_s[i] = to_f32(wt[i]);
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
    const int co = co0 + cl;
    const int pr = pr0 + rest / ct;
    if (pr >= g.ph) continue;
    const float bias = b ? to_f32(b[co]) : 0.0f;
    const float* wc0 = w_s + cl * g.cin * taps;
    float red = identity;
    for (int i = 0; i < g.pkh; ++i) {
      const int ih0 = cp::in_origin(cp::conv_pos(pr, g.psh, i), g.csh, g.padh);
      for (int j = 0; j < g.pkw; ++j) {
        const int iw0 = cp::in_origin(cp::conv_pos(pc, g.psw, j), g.csw, g.padw);
        float s = 0.0f;
        for (int ci = 0; ci < g.cin; ++ci) {
          const T* xc = xi + ci * plane;
          const float* wc = wc0 + ci * taps;
          for (int dz = 0; dz < g.kh; ++dz) {
            const int ih = ih0 + dz;
            if (!cp::in_bounds(ih, g.h)) continue;
            for (int dt = 0; dt < g.kw; ++dt) {
              const int iw = iw0 + dt;
              if (!cp::in_bounds(iw, g.w)) continue;
              s += to_f32(xc[ih * g.w + iw]) * wc[dz * g.kw + dt];
            }
          }
        }
        s += bias;
        if (relu) s = fmaxf(s, 0.0f);
        red = avg ? red + s : fmaxf(red, s);
      }
    }
    if (avg) red = __fdiv_rn(red, static_cast<float>(g.pkh * g.pkw));
    yi[(co * g.ph + pr) * g.pw + pc] = from_f32<T>(red);
  }
}

template <typename T>
int launch(const void* x, const void* w, const void* b, void* y, int n, int cin,
           int h, int w_, int cout, int kh, int kw, int csh, int csw, int padh,
           int padw, int pkh, int pkw, int psh, int psw, int relu, int avg,
           int rows_per_cta, int cout_tile, long long x_bstride,
           long long y_bstride, void* stream) {
  const cp::Geom g = cp::make_geom(n, cin, h, w_, cout, kh, kw, csh, csw, padh,
                                   padw, pkh, pkw, psh, psw);
  const size_t smem = sizeof(float) * static_cast<size_t>(cout_tile) * cin * kh * kw;
  if (smem > 48 * 1024) {
    cudaError_t e = cudaFuncSetAttribute(conv_pool_kernel<T>,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize,
                                         static_cast<int>(smem));
    if (e != cudaSuccess) return static_cast<int>(e);
  }
  const int work = rows_per_cta * cout_tile * g.pw;
  int threads = ((work + 31) / 32) * 32;
  if (threads > 256) threads = 256;
  const dim3 grid((g.ph + rows_per_cta - 1) / rows_per_cta, n,
                  (cout + cout_tile - 1) / cout_tile);
  conv_pool_kernel<T><<<grid, threads, smem, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const T*>(x), static_cast<const T*>(w), static_cast<const T*>(b),
      static_cast<T*>(y), g, x_bstride, y_bstride, rows_per_cta, cout_tile, relu, avg);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

extern "C" int conv_pool_f32(const void* x, const void* w, const void* b, void* y,
                             int n, int cin, int h, int w_, int cout, int kh, int kw,
                             int csh, int csw, int padh, int padw, int pkh, int pkw,
                             int psh, int psw, int relu, int avg, int rows_per_cta,
                             int cout_tile, long long x_bstride, long long y_bstride,
                             void* stream) {
  return launch<float>(x, w, b, y, n, cin, h, w_, cout, kh, kw, csh, csw, padh, padw,
                       pkh, pkw, psh, psw, relu, avg, rows_per_cta, cout_tile,
                       x_bstride, y_bstride, stream);
}

extern "C" int conv_pool_bf16(const void* x, const void* w, const void* b, void* y,
                              int n, int cin, int h, int w_, int cout, int kh, int kw,
                              int csh, int csw, int padh, int padw, int pkh, int pkw,
                              int psh, int psw, int relu, int avg, int rows_per_cta,
                              int cout_tile, long long x_bstride, long long y_bstride,
                              void* stream) {
  return launch<__nv_bfloat16>(x, w, b, y, n, cin, h, w_, cout, kh, kw, csh, csw, padh,
                               padw, pkh, pkw, psh, psw, relu, avg, rows_per_cta,
                               cout_tile, x_bstride, y_bstride, stream);
}
