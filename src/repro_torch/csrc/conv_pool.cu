// K1: fused dense conv + bias + activation + max/avg pool, f32 or bf16.
//
// Replaces the TPU kernel repro/kernels/conv_pool/kernel.py::_kernel (built
// by conv_pool_call, pallas_call at kernel.py:230; NCHW wrapper
// ops.fused_conv_pool at ops.py:57).  Same function: a dense conv over an
// NCHW input with per-axis kernel/stride/padding, bias, optional ReLU, then
// a max or average pool with per-axis window and stride.  The conv map never
// reaches device memory: a CTA keeps the conv values its pool windows need
// in shared memory.
//
// What bounds it on an H100: at the main path's shapes (LeNet-5's two
// steps, the DS-CNN-KWS and MobileNet-V1 0.25 heads; at most 16 images) the
// work is at most 8.2 M multiply-adds and a few hundred KB, which the card
// moves in well under a microsecond (0.004-0.245 us of f32 operations on the
// CUDA cores; no tensor cores, since TF32 would break the 1e-5 tolerance).
// So launch latency and parallelism bound it: the kernel has to spread a
// call over the card and keep each thread's dependent chain short.
//
// Design (a CTA per (tile of pooled rows, image, tile of output channels);
// kernel.py::k1_tiling picks the tiles for occupancy and shared memory,
// conv_pool_math.cuh holds the tile arithmetic):
// * the channel tile's weights go to shared memory once, as f32, and the
//   input rows and columns the tile's pool windows read
//   (conv_pool_math.cuh::make_tile; padding staged as zeros) go there a
//   chunk of input channels at a time (all of them in one chunk unless they
//   do not fit: a wide layer at a large image), with 16-byte loads where the
//   source is aligned (a whole image at once when the tile reads all of it,
//   as the heads' tiles do);
// * threads over (channel, conv position) each compute one conv value, the
//   dot over cin x taps from shared memory in the order the earlier
//   one-thread-per-output design used (cin outer, then kernel rows, then
//   kernel columns), its partial sum kept in a conv tile in shared memory
//   from one chunk to the next, then bias and ReLU;
// * after one barrier, threads over (channel, pooled position) reduce each
//   window from the conv tile in row-major order (the average by one
//   correctly rounded divide) and write the output;
// * the input is read straight from NCHW with a batch stride, and the output
//   written with one, so a step can read from and write into the two banks
//   of the ping-pong arena without copies.
// A zero padding tap adds fma(0, w, s) = s, so each value equals that
// design's, which skipped such taps.
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

#include <algorithm>

#include "conv_pool_math.cuh"

namespace {

constexpr long long kMaxSmemBytes = 232448;  // what one CTA may have on Hopper

__device__ __forceinline__ float to_f32(float v) { return v; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 v) { return __bfloat162float(v); }

template <typename T> __device__ __forceinline__ T from_f32(float v);
template <> __device__ __forceinline__ float from_f32<float>(float v) { return v; }
template <> __device__ __forceinline__ __nv_bfloat16 from_f32<__nv_bfloat16>(float v) {
  return __float2bfloat16_rn(v);
}

// Loads a thread keeps in flight while it stages: each staging loop issues
// this many global loads before it stores any, so a thread waits for one
// round trip to memory per kUnroll elements, not per element.
constexpr int kUnroll = 4;

// 16 loaded bytes of T, widened to f32, to dst (16-byte aligned).
template <typename T> __device__ __forceinline__ void widen16(float* dst, uint4 u);
template <> __device__ __forceinline__ void widen16<float>(float* dst, uint4 u) {
  *reinterpret_cast<uint4*>(dst) = u;
}
template <> __device__ __forceinline__ void widen16<__nv_bfloat16>(float* dst, uint4 u) {
  const __nv_bfloat162* h = reinterpret_cast<const __nv_bfloat162*>(&u);
  const float2 a = __bfloat1622float2(h[0]), b = __bfloat1622float2(h[1]);
  const float2 c = __bfloat1622float2(h[2]), d = __bfloat1622float2(h[3]);
  reinterpret_cast<float4*>(dst)[0] = make_float4(a.x, a.y, b.x, b.y);
  reinterpret_cast<float4*>(dst)[1] = make_float4(c.x, c.y, d.x, d.y);
}

// dst[0, count) = f32(src[0, count)), dst 16-byte aligned: 16-byte loads
// when src is aligned too, coalesced scalar loads for the rest.
template <typename T>
__device__ void stage_flat(float* dst, const T* __restrict__ src, int count) {
  constexpr int V = 16 / sizeof(T);
  int done = 0;
  if ((reinterpret_cast<uintptr_t>(src) & 15) == 0) {
    const int nv = count / V;
    const uint4* s4 = reinterpret_cast<const uint4*>(src);
    for (int i0 = threadIdx.x; i0 < nv; i0 += kUnroll * blockDim.x) {
      uint4 u[kUnroll];
#pragma unroll
      for (int k = 0; k < kUnroll; ++k) {
        const int i = i0 + k * blockDim.x;
        if (i < nv) u[k] = __ldg(s4 + i);
      }
#pragma unroll
      for (int k = 0; k < kUnroll; ++k) {
        const int i = i0 + k * blockDim.x;
        if (i < nv) widen16<T>(dst + i * V, u[k]);
      }
    }
    done = nv * V;
  }
  for (int i = done + threadIdx.x; i < count; i += blockDim.x) dst[i] = to_f32(src[i]);
}

template <typename T>
__global__ void conv_pool_kernel(const T* __restrict__ x, const T* __restrict__ w,
                                 const T* __restrict__ b, T* __restrict__ y,
                                 cp::Geom g, long long x_bstride, long long y_bstride,
                                 int rows_per_cta, int cout_tile, int cin_chunk, int relu,
                                 int avg) {
  extern __shared__ float4 smem4[];
  const int taps = g.kh * g.kw;
  const int co0 = blockIdx.z * cout_tile;
  const int ct = min(cout_tile, g.cout - co0);
  const int img = blockIdx.y;
  const int p0 = blockIdx.x * rows_per_cta;
  const cp::Tile full = cp::make_tile(g, rows_per_cta);
  const cp::Tile t = cp::make_tile(g, min(rows_per_cta, g.ph - p0));
  float* w_s = reinterpret_cast<float*>(smem4);
  float* x_s = w_s + cp::words16(static_cast<long long>(cout_tile) * g.cin * taps);
  float* c_s = x_s + cp::words16(static_cast<long long>(cin_chunk) * full.hrows * full.wcols);

  stage_flat(w_s, w + static_cast<long long>(co0) * g.cin * taps, ct * g.cin * taps);
  const T* xi = x + img * x_bstride;
  const int ih0 = cp::tile_in_row0(p0, g.psh, g.csh, g.padh);
  const int plane = t.hrows * t.wcols;  // one staged input channel
  const bool whole = ih0 == 0 && t.hrows == g.h && g.padw == 0 && t.wcols == g.w;
  const int cplane = t.crows * t.ccols;

  // The input channels in chunks of cin_chunk, each staged in turn: a conv
  // value's partial sum waits in the conv tile between chunks, so the sum
  // runs over the input channels in the same order as with one chunk.
  for (int c0 = 0; c0 < g.cin; c0 += cin_chunk) {
    const int cc = min(cin_chunk, g.cin - c0);
    if (c0 > 0) __syncthreads();  // every thread is done with the last chunk
    const T* xc0 = xi + static_cast<long long>(c0) * g.h * g.w;
    if (whole) {
      stage_flat(x_s, xc0, cc * plane);  // the tile reads the whole image
    } else {
      for (int e0 = threadIdx.x; e0 < cc * plane; e0 += kUnroll * blockDim.x) {
        float v[kUnroll];
#pragma unroll
        for (int k = 0; k < kUnroll; ++k) {
          const int e = e0 + k * blockDim.x;
          const int ci = e / plane, rem = e % plane;
          const int ih = ih0 + rem / t.wcols, iw = rem % t.wcols - g.padw;
          v[k] = e < cc * plane && cp::in_bounds(ih, g.h) && cp::in_bounds(iw, g.w)
                     ? to_f32(xc0[(static_cast<long long>(ci) * g.h + ih) * g.w + iw])
                     : 0.0f;
        }
#pragma unroll
        for (int k = 0; k < kUnroll; ++k)
          if (e0 + k * blockDim.x < cc * plane) x_s[e0 + k * blockDim.x] = v[k];
      }
    }
    __syncthreads();

    // One conv value a thread: conv row r and column c of the tile.
    const bool last = c0 + cc == g.cin;
    for (int e = threadIdx.x; e < ct * cplane; e += blockDim.x) {
      const int cl = e / cplane, rem = e % cplane;
      const int r = rem / t.ccols, c = rem % t.ccols;
      const float* xo = x_s + r * g.csh * t.wcols + c * g.csw;
      const float* wc = w_s + (static_cast<long long>(cl) * g.cin + c0) * taps;
      float s = c0 == 0 ? 0.0f : c_s[e];
      if (taps == 1) {
#pragma unroll 8
        for (int ci = 0; ci < cc; ++ci) s = fmaf(xo[ci * plane], wc[ci], s);
      } else {
        for (int ci = 0; ci < cc; ++ci) {
          const float* xc = xo + ci * plane;
          const float* wk = wc + ci * taps;
          for (int dz = 0; dz < g.kh; ++dz)
            for (int dt = 0; dt < g.kw; ++dt)
              s = fmaf(xc[dz * t.wcols + dt], wk[dz * g.kw + dt], s);
        }
      }
      if (last) {
        s += b ? to_f32(b[co0 + cl]) : 0.0f;
        if (relu) s = fmaxf(s, 0.0f);
      }
      c_s[e] = s;
    }
  }
  __syncthreads();

  // One pooled value a thread, its window reduced in row-major order.
  T* yi = y + img * y_bstride;
  for (int e = threadIdx.x; e < ct * t.rows * g.pw; e += blockDim.x) {
    const int pc = e % g.pw, rest = e / g.pw;
    const int pr = rest % t.rows, cl = rest / t.rows;
    const float* cw = c_s + cl * cplane + pr * g.psh * t.ccols + pc * g.psw;
    float red;
    if (avg) {
      red = 0.0f;
      for (int i = 0; i < g.pkh; ++i) {
#pragma unroll 4
        for (int j = 0; j < g.pkw; ++j) red += cw[i * t.ccols + j];
      }
      red = __fdiv_rn(red, static_cast<float>(g.pkh * g.pkw));
    } else {
      red = -INFINITY;
      for (int i = 0; i < g.pkh; ++i) {
#pragma unroll 4
        for (int j = 0; j < g.pkw; ++j) red = fmaxf(red, cw[i * t.ccols + j]);
      }
    }
    yi[(static_cast<long long>(co0 + cl) * g.ph + p0 + pr) * g.pw + pc] = from_f32<T>(red);
  }
}

template <typename T>
int launch(const void* x, const void* w, const void* b, void* y, int n, int cin,
           int h, int w_, int cout, int kh, int kw, int csh, int csw, int padh,
           int padw, int pkh, int pkw, int psh, int psw, int relu, int avg,
           int rows_per_cta, int cout_tile, int cin_chunk, long long x_bstride,
           long long y_bstride, void* stream) {
  const cp::Geom g = cp::make_geom(n, cin, h, w_, cout, kh, kw, csh, csw, padh,
                                   padw, pkh, pkw, psh, psw);
  if (rows_per_cta < 1 || cout_tile < 1 || cin_chunk < 1 || cin_chunk > cin)
    return static_cast<int>(cudaErrorInvalidValue);
  const long long smem = cp::k1_smem_bytes(g, rows_per_cta, cout_tile, cin_chunk);
  if (smem > kMaxSmemBytes)
    return static_cast<int>(cudaErrorInvalidValue);
  if (smem > 48 * 1024) {
    cudaError_t e = cudaFuncSetAttribute(conv_pool_kernel<T>,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize,
                                         static_cast<int>(smem));
    if (e != cudaSuccess) return static_cast<int>(e);
  }
  const cp::Tile t = cp::make_tile(g, rows_per_cta);
  const int work = std::max(cout_tile * t.crows * t.ccols, cout_tile * rows_per_cta * g.pw);
  const int threads = std::min(256, std::max(64, (work + 31) / 32 * 32));
  const dim3 grid((g.ph + rows_per_cta - 1) / rows_per_cta, n,
                  (cout + cout_tile - 1) / cout_tile);
  conv_pool_kernel<T><<<grid, threads, static_cast<size_t>(smem),
                        static_cast<cudaStream_t>(stream)>>>(
      static_cast<const T*>(x), static_cast<const T*>(w), static_cast<const T*>(b),
      static_cast<T*>(y), g, x_bstride, y_bstride, rows_per_cta, cout_tile, cin_chunk, relu,
      avg);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

extern "C" int conv_pool_f32(const void* x, const void* w, const void* b, void* y,
                             int n, int cin, int h, int w_, int cout, int kh, int kw,
                             int csh, int csw, int padh, int padw, int pkh, int pkw,
                             int psh, int psw, int relu, int avg, int rows_per_cta,
                             int cout_tile, int cin_chunk, long long x_bstride,
                             long long y_bstride, void* stream) {
  return launch<float>(x, w, b, y, n, cin, h, w_, cout, kh, kw, csh, csw, padh, padw,
                       pkh, pkw, psh, psw, relu, avg, rows_per_cta, cout_tile, cin_chunk,
                       x_bstride, y_bstride, stream);
}

extern "C" int conv_pool_bf16(const void* x, const void* w, const void* b, void* y,
                              int n, int cin, int h, int w_, int cout, int kh, int kw,
                              int csh, int csw, int padh, int padw, int pkh, int pkw,
                              int psh, int psw, int relu, int avg, int rows_per_cta,
                              int cout_tile, int cin_chunk, long long x_bstride,
                              long long y_bstride, void* stream) {
  return launch<__nv_bfloat16>(x, w, b, y, n, cin, h, w_, cout, kh, kw, csh, csw, padh,
                               padw, pkh, pkw, psh, psw, relu, avg, rows_per_cta,
                               cout_tile, cin_chunk, x_bstride, y_bstride, stream);
}
