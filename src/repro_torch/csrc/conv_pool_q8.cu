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
// The wrapper rejects a negative multiplier for max pools.  Integer sums are
// exact and associative (two's-complement wrap included), so the conv and
// window sums may run in any order and stay bit-exact; only the one
// requantization of the pooled value has an order, and it is the
// reference's.
//
// What bounds it on an H100: at the main path's shapes (the §5 CIFAR
// steps, the DS-CNN-KWS and MobileNet-V1 0.25 int8 heads; at most 16
// images) the work is at most a few tens of M int8 multiply-adds and well
// under a MB, far below a microsecond at the card's rates, so launch
// latency and parallelism bound it: the kernel has to spread a call over
// the card and keep each thread's dependent chain short.
//
// Design, K1's (conv_pool.cu) in int8: a CTA per (tile of pooled rows,
// image, tile of output channels); kernel.py::k2_tiling picks the tiles for
// occupancy and shared memory (conv_pool_math.cuh::k2_smem_bytes):
// * the channel tile's weights go to shared memory once, and the input rows
//   and columns the tile's pool windows read (padding staged as zeros) a
//   chunk of input channels at a time, both with the channels innermost,
//   4 int8 channels a 32-bit word (zero-padded to whole words);
// * threads over (channel, conv position) each compute one int32 conv
//   value, a __dp4a per 4 input channels and tap, its partial sum kept in
//   the int32 conv tile from one chunk to the next, then bias and ReLU;
// * after one barrier, threads over (channel, pooled position) reduce each
//   window from the conv tile, a warp a window where the window has 32
//   values or more (the DS-CNN-KWS head's 25x5), and requantize once;
// * the input is read straight from NCHW with a batch stride, and the output
//   written with one, so a step can read from and write into the two banks
//   of the ping-pong arena without copies.
#include <cuda_runtime.h>
#include <stdint.h>

#include <algorithm>

#include "conv_pool_math.cuh"

namespace {

constexpr long long kMaxSmemBytes = 232448;  // what one CTA may have on Hopper

// 4 int8 values packed into one 32-bit word, the first in the low byte.
__device__ __forceinline__ int pack4(int a, int b, int c, int d) {
  return static_cast<int>((a & 0xffu) | ((b & 0xffu) << 8) | ((c & 0xffu) << 16) |
                          ((d & 0xffu) << 24));
}

__global__ void conv_pool_q8_kernel(const int8_t* __restrict__ x,
                                    const int8_t* __restrict__ w,
                                    const int32_t* __restrict__ b,
                                    int8_t* __restrict__ y, cp::Geom g, float m,
                                    long long x_bstride, long long y_bstride,
                                    int rows_per_cta, int cout_tile, int cin_chunk,
                                    int relu, int avg) {
  extern __shared__ int4 smem4[];
  const int taps = g.kh * g.kw;
  const int cinw = (g.cin + 3) / 4;  // weight words per (channel, tap)
  const int co0 = blockIdx.z * cout_tile;
  const int ct = min(cout_tile, g.cout - co0);
  const int img = blockIdx.y;
  const int p0 = blockIdx.x * rows_per_cta;
  const cp::Tile full = cp::make_tile(g, rows_per_cta);
  const cp::Tile t = cp::make_tile(g, min(rows_per_cta, g.ph - p0));
  const int xs = cp::k2_pos_words(cin_chunk);  // words a staged position
  int* w_s = reinterpret_cast<int*>(smem4);
  int* x_s = w_s + cp::words16(static_cast<long long>(cout_tile) * taps * cinw);
  int* c_s = x_s + cp::words16(static_cast<long long>(full.hrows) * full.wcols * xs);

  // weights: (channel of the tile, tap, 4 input channels) words
  const int8_t* wt = w + static_cast<long long>(co0) * g.cin * taps;
  for (int e = threadIdx.x; e < ct * taps * cinw; e += blockDim.x) {
    const int q = e % cinw, rest = e / cinw;
    const int tap = rest % taps, cl = rest / taps;
    const int8_t* wc = wt + static_cast<long long>(cl) * g.cin * taps + tap;
    int v[4];
#pragma unroll
    for (int k = 0; k < 4; ++k) {
      const int ci = 4 * q + k;
      v[k] = ci < g.cin ? wc[ci * taps] : 0;
    }
    w_s[e] = pack4(v[0], v[1], v[2], v[3]);
  }

  const int8_t* xi = x + img * x_bstride;
  const int ih0 = cp::tile_in_row0(p0, g.psh, g.csh, g.padh);
  const int npos = t.hrows * t.wcols;  // staged input positions
  const int cplane = t.crows * t.ccols;
  const long long hw = static_cast<long long>(g.h) * g.w;

  // The input channels in chunks of cin_chunk (all of them, or whole words),
  // each staged in turn: a conv value's partial sum waits in the conv tile.
  for (int c0 = 0; c0 < g.cin; c0 += cin_chunk) {
    const int cc = min(cin_chunk, g.cin - c0);
    const int ccw = (cc + 3) / 4;
    if (c0 > 0) __syncthreads();  // every thread is done with the last chunk
    // one word (4 channels of one position) a thread; neighbouring threads
    // read neighbouring columns of a channel
    for (int e = threadIdx.x; e < ccw * npos; e += blockDim.x) {
      const int q = e / npos, pos = e % npos;
      const int ih = ih0 + pos / t.wcols, iw = pos % t.wcols - g.padw;
      int v[4] = {0, 0, 0, 0};
      if (cp::in_bounds(ih, g.h) && cp::in_bounds(iw, g.w)) {
        const int8_t* xp = xi + (c0 + 4 * q) * hw + static_cast<long long>(ih) * g.w + iw;
#pragma unroll
        for (int k = 0; k < 4; ++k)
          if (4 * q + k < cc) v[k] = xp[k * hw];
      }
      x_s[pos * xs + q] = pack4(v[0], v[1], v[2], v[3]);
    }
    __syncthreads();

    // One conv value a thread: conv row r and column c of the tile.  The
    // taps in one flat loop, the staged input's offset stepped along (a
    // kernel row's end jumps to the next input row); one word of channels
    // (cin <= 4, the §5 CIFAR stem) without the inner loop.
    const bool last = c0 + cc == g.cin;
    const int row_skip = (t.wcols - g.kw) * xs;
    for (int e = threadIdx.x; e < ct * cplane; e += blockDim.x) {
      const int cl = e / cplane, rem = e % cplane;
      const int r = rem / t.ccols, c = rem % t.ccols;
      const int* xo = x_s + (r * g.csh * t.wcols + c * g.csw) * xs;
      const int* wc = w_s + cl * taps * cinw + c0 / 4;
      int32_t s = c0 == 0 ? 0 : c_s[e];
      int off = 0, dt = 0;
      if (ccw == 1) {
        for (int m = 0; m < taps; ++m) {
          s = __dp4a(xo[off], wc[m * cinw], s);
          off += xs;
          if (++dt == g.kw) {
            dt = 0;
            off += row_skip;
          }
        }
      } else {
        for (int m = 0; m < taps; ++m) {
          const int* xp = xo + off;
          const int* wp = wc + m * cinw;
#pragma unroll 4
          for (int q = 0; q < ccw; ++q) s = __dp4a(xp[q], wp[q], s);
          off += xs;
          if (++dt == g.kw) {
            dt = 0;
            off += row_skip;
          }
        }
      }
      if (last) {
        s += b ? b[co0 + cl] : 0;
        if (relu) s = max(s, 0);
      }
      c_s[e] = s;
    }
  }
  __syncthreads();

  // One pooled value a thread, or a warp a pooled value for large windows;
  // then one requant.
  int8_t* yi = y + img * y_bstride;
  const int win = g.pkh * g.pkw;
  const int pooled = ct * t.rows * g.pw;
  const bool split = win >= 32;
  const int lane = split ? threadIdx.x % 32 : 0;
  const int step = split ? blockDim.x / 32 : blockDim.x;
  for (int e = split ? threadIdx.x / 32 : threadIdx.x; e < pooled; e += step) {
    const int pc = e % g.pw, rest = e / g.pw;
    const int pr = rest % t.rows, cl = rest / t.rows;
    const int32_t* cw = c_s + cl * cplane + pr * g.psh * t.ccols + pc * g.psw;
    int32_t red = avg ? 0 : INT32_MIN;
    for (int j = lane; j < win; j += split ? 32 : 1) {
      const int32_t v = cw[(j / g.pkw) * t.ccols + j % g.pkw];
      red = avg ? red + v : max(red, v);
    }
    if (split) {
#pragma unroll
      for (int o = 16; o > 0; o >>= 1) {
        const int32_t v = __shfl_xor_sync(0xffffffffu, red, o);
        red = avg ? red + v : max(red, v);
      }
    }
    if (lane == 0)
      yi[(static_cast<long long>(co0 + cl) * g.ph + p0 + pr) * g.pw + pc] = cp::requant(red, m);
  }
}

}  // namespace

extern "C" int conv_pool_q8(const void* x, const void* w, const void* b, void* y,
                            int n, int cin, int h, int w_, int cout, int kh, int kw,
                            int csh, int csw, int padh, int padw, int pkh, int pkw,
                            int psh, int psw, int relu, int avg, int rows_per_cta,
                            int cout_tile, int cin_chunk, long long x_bstride,
                            long long y_bstride, float m, void* stream) {
  const cp::Geom g = cp::make_geom(n, cin, h, w_, cout, kh, kw, csh, csw, padh,
                                   padw, pkh, pkw, psh, psw);
  if (rows_per_cta < 1 || cout_tile < 1 || cin_chunk < 1 || cin_chunk > cin ||
      (cin_chunk < cin && cin_chunk % 4 != 0))
    return static_cast<int>(cudaErrorInvalidValue);
  const long long smem = cp::k2_smem_bytes(g, rows_per_cta, cout_tile, cin_chunk);
  if (smem > kMaxSmemBytes) return static_cast<int>(cudaErrorInvalidValue);
  if (smem > 48 * 1024) {
    cudaError_t e = cudaFuncSetAttribute(conv_pool_q8_kernel,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize,
                                         static_cast<int>(smem));
    if (e != cudaSuccess) return static_cast<int>(e);
  }
  const cp::Tile t = cp::make_tile(g, rows_per_cta);
  const int win = pkh * pkw;
  const int pool_threads = cout_tile * rows_per_cta * g.pw * (win >= 32 ? 32 : 1);
  const int work = std::max(cout_tile * t.crows * t.ccols, pool_threads);
  const int threads = std::min(256, std::max(64, (work + 31) / 32 * 32));
  const dim3 grid((g.ph + rows_per_cta - 1) / rows_per_cta, n,
                  (cout + cout_tile - 1) / cout_tile);
  conv_pool_q8_kernel<<<grid, threads, static_cast<size_t>(smem),
                        static_cast<cudaStream_t>(stream)>>>(
      static_cast<const int8_t*>(x), static_cast<const int8_t*>(w),
      static_cast<const int32_t*>(b), static_cast<int8_t*>(y), g, m, x_bstride,
      y_bstride, rows_per_cta, cout_tile, cin_chunk, relu, avg);
  return static_cast<int>(cudaGetLastError());
}
