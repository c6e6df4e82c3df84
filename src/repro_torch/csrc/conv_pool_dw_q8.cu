// K4: fused int8 depthwise conv + int32 bias + ReLU + max/sum pool + one
// per-channel requant.
//
// Replaces the TPU kernel repro/quant/kernel_q8.py::_kernel_dw_q8 (pallas_call
// through repro/kernels/conv_pool/kernel.py::conv_pool_call with the (C,)
// multipliers as an extra operand; entry point fused_depthwise_conv_pool_q8
// at kernel_q8.py:338).  Same function: an int8 x int8 depthwise conv
// (groups = C) accumulated in int32, the int32 bias (accumulator scale)
// added, ReLU in the accumulator domain, then a max pool or an int32 window
// sum, then one requantization of the pooled value with channel c's
// multiplier m[c] (conv_pool_math.cuh::requant_per_channel: f32 product,
// rint half to even, saturate).  For an average pool the host passes each
// m[c] already divided, in f32, by pkh*pkw (kernel_q8.py:134).
//
// Order of max/ReLU and requant: the kernel takes the max of the int32
// accumulators and requantizes once.  For m[c] >= 0 requant is monotone
// non-decreasing and maps 0 to 0, so this equals requantizing first and
// then taking the max, and a ReLU view after the step, folded into this
// kernel as relu=1, equals max(requant(acc), 0).  The wrapper rejects a
// negative multiplier wherever that order matters.
//
// What bounds it on an H100: as K3 (conv_pool_dw.cu), bytes, and at the
// main path's sizes (at most ~0.5 MB a call) a launch.  Exact integer
// arithmetic on the CUDA cores.
//
// Design: K3's grid and thread mapping (one CTA per (tile of pooled rows,
// image, tile of channels), taps of the channel tile in shared memory, one
// thread per (channel, pooled column)), with an int32 accumulator and the
// per-channel multipliers read from a (C,) f32 device array.
#include <cuda_runtime.h>
#include <stdint.h>

#include "conv_pool_math.cuh"

namespace {

__global__ void conv_pool_dw_q8_kernel(const int8_t* __restrict__ x,
                                       const int8_t* __restrict__ w,
                                       const int32_t* __restrict__ b,
                                       int8_t* __restrict__ y,
                                       const float* __restrict__ ms, cp::Geom g,
                                       long long x_bstride, long long y_bstride,
                                       int rows_per_cta, int c_tile, int relu, int avg) {
  extern __shared__ int8_t wq_s[];  // (channels of this tile, kh, kw) int8
  const int taps = g.kh * g.kw;
  const int c0 = blockIdx.z * c_tile;
  const int ct = min(c_tile, g.cout - c0);
  const int8_t* wt = w + static_cast<long long>(c0) * taps;
  for (int i = threadIdx.x; i < ct * taps; i += blockDim.x) wq_s[i] = wt[i];
  __syncthreads();

  const int img = blockIdx.y;
  const int pr0 = blockIdx.x * rows_per_cta;
  const int8_t* xi = x + img * x_bstride;
  int8_t* yi = y + img * y_bstride;
  const int plane = g.h * g.w;
  const int work = rows_per_cta * ct * g.pw;

  for (int t = threadIdx.x; t < work; t += blockDim.x) {
    const int pc = t % g.pw;
    const int rest = t / g.pw;
    const int cl = rest % ct;
    const int c = c0 + cl;
    const int pr = pr0 + rest / ct;
    if (pr >= g.ph) continue;
    const int32_t bias = b ? b[c] : 0;
    const int8_t* xc = xi + static_cast<long long>(c) * plane;
    const int8_t* wc = wq_s + cl * taps;
    int32_t red = avg ? 0 : INT32_MIN;
    for (int i = 0; i < g.pkh; ++i) {
      const int ih0 = cp::in_origin(cp::conv_pos(pr, g.psh, i), g.csh, g.padh);
      for (int j = 0; j < g.pkw; ++j) {
        const int iw0 = cp::in_origin(cp::conv_pos(pc, g.psw, j), g.csw, g.padw);
        int32_t acc = 0;
        for (int dz = 0; dz < g.kh; ++dz) {
          const int ih = ih0 + dz;
          if (!cp::in_bounds(ih, g.h)) continue;
          for (int dt = 0; dt < g.kw; ++dt) {
            const int iw = iw0 + dt;
            if (!cp::in_bounds(iw, g.w)) continue;
            acc += static_cast<int32_t>(xc[ih * g.w + iw]) *
                   static_cast<int32_t>(wc[dz * g.kw + dt]);
          }
        }
        acc += bias;
        if (relu) acc = max(acc, 0);
        red = avg ? red + acc : max(red, acc);
      }
    }
    yi[(static_cast<long long>(c) * g.ph + pr) * g.pw + pc] =
        cp::requant_per_channel(red, ms, c);
  }
}

}  // namespace

extern "C" int conv_pool_dw_q8(const void* x, const void* w, const void* b, void* y,
                               int n, int cin, int h, int w_, int cout, int kh, int kw,
                               int csh, int csw, int padh, int padw, int pkh, int pkw,
                               int psh, int psw, int relu, int avg, int rows_per_cta,
                               int c_tile, long long x_bstride, long long y_bstride,
                               const void* ms, void* stream) {
  const cp::Geom g = cp::make_geom(n, cin, h, w_, cout, kh, kw, csh, csw, padh,
                                   padw, pkh, pkw, psh, psw);
  const size_t smem = static_cast<size_t>(c_tile) * kh * kw;
  if (smem > 48 * 1024) {
    cudaError_t e = cudaFuncSetAttribute(conv_pool_dw_q8_kernel,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize,
                                         static_cast<int>(smem));
    if (e != cudaSuccess) return static_cast<int>(e);
  }
  const int work = rows_per_cta * c_tile * g.pw;
  int threads = ((work + 31) / 32) * 32;
  if (threads > 256) threads = 256;
  const dim3 grid((g.ph + rows_per_cta - 1) / rows_per_cta, n,
                  (cout + c_tile - 1) / c_tile);
  conv_pool_dw_q8_kernel<<<grid, threads, smem, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const int8_t*>(x), static_cast<const int8_t*>(w),
      static_cast<const int32_t*>(b), static_cast<int8_t*>(y),
      static_cast<const float*>(ms), g, x_bstride, y_bstride, rows_per_cta, c_tile,
      relu, avg);
  return static_cast<int>(cudaGetLastError());
}
