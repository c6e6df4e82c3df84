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
// multiplier m[c] (conv_pool_math.cuh::requant, as requant_per_channel:
// f32 product, rint half to even, saturate).  For an average pool the host passes each
// m[c] already divided, in f32, by pkh*pkw (kernel_q8.py:134).
//
// Order of max/ReLU and requant: the kernel takes the max of the int32
// accumulators and requantizes once.  For m[c] >= 0 requant is monotone
// non-decreasing and maps 0 to 0, so this equals requantizing first and
// then taking the max, and a ReLU view after the step, folded into this
// kernel as relu=1, equals max(requant(acc), 0).  The wrapper rejects a
// negative multiplier wherever that order matters.
//
// What bounds it on an H100: as K3 (conv_pool_dw.cu), bytes, a quarter of
// K3's at int8, and at the main path's sizes (at most ~0.5 MB a call) the
// latency of one launch and of its trips to memory.  Exact integer
// arithmetic on the CUDA cores: int32 sums are exact in any order, so the
// kernel is bit-exact against its plain version whatever order it sums in.
//
// Design, K3's for latency (conv_pool_dw.cu), in int8:
// * one output a thread, over a grid of (tile of pooled rows, image, tile of
//   channels) that depthwise.py::k3_tiling sizes to reach one CTA per SM of
//   the card (132) where the call has a warp of outputs for each;
// * neighbouring threads take neighbouring pooled columns of one channel;
// * each thread reads its channel's taps (9 bytes for 3x3, the same
//   addresses for every thread of the channel: one broadcast), bias and
//   multiplier straight from device memory, once, before its input loads
//   (read at the requant, it cost 0.1-0.2 us a call more on an H100): no
//   staging of every channel's taps behind a barrier before the first
//   input load;
// * the 3x3 filter of every depthwise step of DS-CNN-KWS and MobileNet-V1
//   0.25 is a template case with the 9 taps and 9 inputs of a conv value
//   unrolled and the zero padding a predicate on each input load, so all
//   loads are in flight together; other filter shapes loop over their taps;
// * input and output are batch-strided NCHW, so a step reads one arena
//   buffer and writes another in place.
#include <cuda_runtime.h>
#include <stdint.h>

#include "conv_pool_math.cuh"

namespace {

// One int32 conv value at conv position (oh, ow) of channel plane xc.  K = 3
// unrolls a 3x3 filter (taps in wr); K = 0 walks g.kh x g.kw taps read from
// wc.  A padding tap contributes 0 * w = 0.
template <int K>
__device__ __forceinline__ int32_t conv_value(const int8_t* __restrict__ xc,
                                              const int8_t* __restrict__ wc,
                                              const int32_t* wr, const cp::Geom& g,
                                              int oh, int ow) {
  const int ih0 = cp::in_origin(oh, g.csh, g.padh);
  const int iw0 = cp::in_origin(ow, g.csw, g.padw);
  int32_t s = 0;
  if (K == 3) {
    int32_t v[9];
#pragma unroll
    for (int dz = 0; dz < 3; ++dz) {
#pragma unroll
      for (int dt = 0; dt < 3; ++dt) {
        const int ih = ih0 + dz, iw = iw0 + dt;
        const bool ok = cp::in_bounds(ih, g.h) && cp::in_bounds(iw, g.w);
        v[dz * 3 + dt] = ok ? static_cast<int32_t>(__ldg(xc + ih * g.w + iw)) : 0;
      }
    }
#pragma unroll
    for (int q = 0; q < 9; ++q) s += v[q] * wr[q];
  } else {
    for (int dz = 0; dz < g.kh; ++dz) {
      const int ih = ih0 + dz;
      for (int dt = 0; dt < g.kw; ++dt) {
        const int iw = iw0 + dt;
        const bool ok = cp::in_bounds(ih, g.h) && cp::in_bounds(iw, g.w);
        const int32_t xv = ok ? static_cast<int32_t>(__ldg(xc + ih * g.w + iw)) : 0;
        s += xv * static_cast<int32_t>(__ldg(wc + dz * g.kw + dt));
      }
    }
  }
  return s;
}

template <int K>
__global__ void __launch_bounds__(256)
conv_pool_dw_q8_kernel(const int8_t* __restrict__ x, const int8_t* __restrict__ w,
                       const int32_t* __restrict__ b, int8_t* __restrict__ y,
                       const float* __restrict__ ms, cp::Geom g, long long x_bstride,
                       long long y_bstride, int rows_per_cta, int c_tile, int relu,
                       int avg) {
  const int c0 = blockIdx.z * c_tile;
  const int ct = min(c_tile, g.cout - c0);
  const int pr0 = blockIdx.x * rows_per_cta;
  const int rows = min(rows_per_cta, g.ph - pr0);
  const int img = blockIdx.y;
  const int8_t* xi = x + img * x_bstride;
  int8_t* yi = y + img * y_bstride;
  const int plane = g.h * g.w;

  for (int e = threadIdx.x; e < ct * rows * g.pw; e += blockDim.x) {
    const int pc = e % g.pw, rest = e / g.pw;
    const int pr = pr0 + rest % rows, c = c0 + rest / rows;
    const int8_t* xc = xi + static_cast<long long>(c) * plane;
    const int8_t* wc = w + c * g.kh * g.kw;
    int32_t wr[9];
    if (K == 3) {
#pragma unroll
      for (int q = 0; q < 9; ++q) wr[q] = static_cast<int32_t>(__ldg(wc + q));
    }
    const int32_t bias = b ? __ldg(b + c) : 0;
    const float m = __ldg(ms + c);
    int32_t red = avg ? 0 : INT32_MIN;
    for (int i = 0; i < g.pkh; ++i) {
      const int oh = cp::conv_pos(pr, g.psh, i);
      for (int j = 0; j < g.pkw; ++j) {
        int32_t acc = conv_value<K>(xc, wc, wr, g, oh, cp::conv_pos(pc, g.psw, j)) + bias;
        if (relu) acc = max(acc, 0);
        red = avg ? red + acc : max(red, acc);
      }
    }
    yi[(static_cast<long long>(c) * g.ph + pr) * g.pw + pc] = cp::requant(red, m);
  }
}

}  // namespace

extern "C" int conv_pool_dw_q8(const void* x, const void* w, const void* b, void* y,
                               int n, int cin, int h, int w_, int cout, int kh, int kw,
                               int csh, int csw, int padh, int padw, int pkh, int pkw,
                               int psh, int psw, int relu, int avg, int rows_per_cta,
                               int c_tile, long long x_bstride, long long y_bstride,
                               const void* ms, void* stream) {
  if (rows_per_cta < 1 || c_tile < 1) return static_cast<int>(cudaErrorInvalidValue);
  const cp::Geom g = cp::make_geom(n, cin, h, w_, cout, kh, kw, csh, csw, padh,
                                   padw, pkh, pkw, psh, psw);
  const long long work = static_cast<long long>(rows_per_cta) * c_tile * g.pw;
  const int threads = static_cast<int>(work < 256 ? (work + 31) / 32 * 32 : 256);
  const dim3 grid((g.ph + rows_per_cta - 1) / rows_per_cta, n,
                  (cout + c_tile - 1) / c_tile);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const int8_t* xt = static_cast<const int8_t*>(x);
  const int8_t* wt = static_cast<const int8_t*>(w);
  const int32_t* bt = static_cast<const int32_t*>(b);
  int8_t* yt = static_cast<int8_t*>(y);
  const float* mt = static_cast<const float*>(ms);
  if (kh == 3 && kw == 3)
    conv_pool_dw_q8_kernel<3><<<grid, threads, 0, s>>>(xt, wt, bt, yt, mt, g, x_bstride,
                                                       y_bstride, rows_per_cta, c_tile,
                                                       relu, avg);
  else
    conv_pool_dw_q8_kernel<0><<<grid, threads, 0, s>>>(xt, wt, bt, yt, mt, g, x_bstride,
                                                       y_bstride, rows_per_cta, c_tile,
                                                       relu, avg);
  return static_cast<int>(cudaGetLastError());
}
