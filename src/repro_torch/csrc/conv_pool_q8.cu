// K2: fused int8 conv + int32 bias + ReLU + max/sum pool + one requant.
//
// Replaces the TPU kernel repro/quant/kernel_q8.py::_kernel_q8 (pallas_call
// through repro/kernels/conv_pool/kernel.py::conv_pool_call; entry point
// fused_conv_pool_q8 at kernel_q8.py:207).  Same function: an int8 x int8
// dense conv accumulated in int32, the int32 bias (accumulator scale) added,
// ReLU in the accumulator domain, then a max pool or an int32 window sum,
// then one requantization of the pooled value (kernel_q8.py:87-92):
//   v = __fmul_rn(__int2float_rn(acc), m); rintf (half to even);
//   clamp to [-128, 127] in float; cast to int8.
// For an average pool the host passes m already divided, in f32, by
// pkh*pkw, exactly as the reference forms it.
//
// Order of max pool and requant: this kernel takes the max of the int32
// accumulators and requantizes once, while the reference executor
// (quant/exec.py::apply_int8_layer) requantizes every conv value and then
// takes the max.  The two are bit-identical: for m >= 0 requant is a
// composition of monotone non-decreasing steps (int->float rounding, a
// product by m rounded to nearest, rint, clamp), so it commutes with max.
// The wrapper rejects a negative multiplier for max pools.
//
// What bounds it on an H100: at the paper's §5 CIFAR shapes (3->32 at
// 32x32, 32->16 at 16x16, 16->32 at 8x8, 5x5, at most 16 images) the work
// is a few to a few tens of MOP and well under a MB, far below a
// microsecond at the card's rates, so a launch bounds it.  Exact integer
// arithmetic on the CUDA cores; no dp4a or int8 tensor-core MMA yet.
//
// Design: the same structure as K1 (conv_pool.cu): one CTA per (tile of
// pooled rows, image, tile of output channels), the int8 weights of its
// channel tile in shared memory (one tile holds a whole layer up to 227 KB;
// 12.8 KB for CIFAR conv2, 64 KB for MobileNet's head), one thread per (out channel, pooled column) walking the tile's
// pooled rows with an int32 accumulator, padding as bounds-checked zero taps
// (symmetric quantization: the zero point is 0), batch-strided NCHW input
// and output so the arena banks are read and written in place.
#include <cuda_runtime.h>
#include <stdint.h>

#include "conv_pool_math.cuh"

namespace {

__global__ void conv_pool_q8_kernel(const int8_t* __restrict__ x,
                                    const int8_t* __restrict__ w,
                                    const int32_t* __restrict__ b,
                                    int8_t* __restrict__ y, cp::Geom g, float m,
                                    long long x_bstride, long long y_bstride,
                                    int rows_per_cta, int cout_tile, int relu, int avg) {
  extern __shared__ int8_t wq_s[];  // (channels of this tile, cin, kh, kw) int8
  const int taps = g.kh * g.kw;
  const int co0 = blockIdx.z * cout_tile;
  const int ct = min(cout_tile, g.cout - co0);
  const int n_w = ct * g.cin * taps;
  const int8_t* wt = w + static_cast<long long>(co0) * g.cin * taps;
  for (int i = threadIdx.x; i < n_w; i += blockDim.x) wq_s[i] = wt[i];
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
    const int co = co0 + cl;
    const int pr = pr0 + rest / ct;
    if (pr >= g.ph) continue;
    const int32_t bias = b ? b[co] : 0;
    const int8_t* wc0 = wq_s + cl * g.cin * taps;
    int32_t red = avg ? 0 : INT32_MIN;
    for (int i = 0; i < g.pkh; ++i) {
      const int ih0 = cp::in_origin(cp::conv_pos(pr, g.psh, i), g.csh, g.padh);
      for (int j = 0; j < g.pkw; ++j) {
        const int iw0 = cp::in_origin(cp::conv_pos(pc, g.psw, j), g.csw, g.padw);
        int32_t acc = 0;
        for (int ci = 0; ci < g.cin; ++ci) {
          const int8_t* xc = xi + ci * plane;
          const int8_t* wc = wc0 + ci * taps;
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
        }
        acc += bias;
        if (relu) acc = max(acc, 0);
        red = avg ? red + acc : max(red, acc);
      }
    }
    yi[(co * g.ph + pr) * g.pw + pc] = cp::requant(red, m);
  }
}

}  // namespace

extern "C" int conv_pool_q8(const void* x, const void* w, const void* b, void* y,
                            int n, int cin, int h, int w_, int cout, int kh, int kw,
                            int csh, int csw, int padh, int padw, int pkh, int pkw,
                            int psh, int psw, int relu, int avg, int rows_per_cta,
                            int cout_tile, long long x_bstride, long long y_bstride,
                            float m, void* stream) {
  const cp::Geom g = cp::make_geom(n, cin, h, w_, cout, kh, kw, csh, csw, padh,
                                   padw, pkh, pkw, psh, psw);
  const size_t smem = static_cast<size_t>(cout_tile) * cin * kh * kw;
  if (smem > 48 * 1024) {
    cudaError_t e = cudaFuncSetAttribute(conv_pool_q8_kernel,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize,
                                         static_cast<int>(smem));
    if (e != cudaSuccess) return static_cast<int>(e);
  }
  const int work = rows_per_cta * cout_tile * g.pw;
  int threads = ((work + 31) / 32) * 32;
  if (threads > 256) threads = 256;
  const dim3 grid((g.ph + rows_per_cta - 1) / rows_per_cta, n,
                  (cout + cout_tile - 1) / cout_tile);
  conv_pool_q8_kernel<<<grid, threads, smem, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const int8_t*>(x), static_cast<const int8_t*>(w),
      static_cast<const int32_t*>(b), static_cast<int8_t*>(y), g, m, x_bstride,
      y_bstride, rows_per_cta, cout_tile, relu, avg);
  return static_cast<int>(cudaGetLastError());
}
