// K6: the LM-head matmul fused with cross-entropy (streaming logsumexp).
//
// Replaces the TPU kernel repro/kernels/xent/kernel.py::_kernel (entry point
// fused_xent_fwd, pallas_call at kernel.py:84).  Same function: for each
// token n, over the vocab ids v < V, the logits l[n, v] = x[n] . w[v] (f32),
// optionally tanh(l / cap) * cap, reduced to a running (max m, rescaled
// sumexp s, target logit t) and written once as m + log(s) - t.  The (N, V)
// logits matrix never reaches device memory.
//
// What bounds it on an H100: at the Llama-3.2-1B train shape (N = 4,096,
// D = 2,048, V = 128,256) a call reads x and w once (~1.1 GB) and does
// 2 N V D = 2.15 TFLOP, so the operations bound it: 32.1 ms at the f32
// CUDA-core peak (67 TFLOP/s) against 0.32 ms of bytes.  This first kernel
// runs its products in f32 on the CUDA cores, as the TPU kernel's f32 dot
// does; TF32 or bf16 wgmma would change the numerics and is later work.
//
// Design:
// * a CTA of 256 threads owns 128 tokens and a contiguous range of the
//   vocab (a "split"); it walks its range in tiles of 128 vocab rows, each
//   tile a 128 x 128 x D f32 product: x and w tiles of depth 8 staged in
//   shared memory (k-major, double-buffered, the next stage prefetched into
//   registers while the current one is multiplied), 8 x 8 outputs a thread;
// * occupancy: N = 4,096 gives only 32 token blocks, so the vocab is split
//   over gridDim.y until the grid fills the card's resident CTA slots (the
//   wrapper picks the split count);
// * each tile's epilogue folds its logits into the per-token running
//   (m, s, t) kept in shared memory: a max and a sum over the 16 threads
//   that share a row by warp shuffles, the softcap and the vocab-tail mask
//   (ids >= V) applied in the kernel; w is never padded or copied;
// * each split writes its (m, s, t) per token to a small scratch; the last
//   CTA of a token block to finish (an atomic ticket after a memory fence)
//   merges the splits in split order and writes the loss, so one launch
//   does the whole call and the result does not depend on which CTA ends
//   last;
// * any N (the token tail is bounds-checked), int32 targets; 16-byte loads
//   when D % 4 == 0 and the rows are 16-byte aligned, scalar loads else.
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace {

constexpr int kBN = 128;       // tokens per CTA
constexpr int kBV = 128;       // vocab rows per tile
constexpr int kBK = 8;         // depth per shared-memory stage
constexpr int kThreads = 256;  // 16 x 16 threads, 8 x 8 outputs each
constexpr int kLd = kBN + 4;   // row stride of a k-major tile (float4-aligned)

// The 8 tile rows (or columns) of thread coordinate c in 0..15: c*4..c*4+3
// and 64+c*4..64+c*4+3, so a warp reads shared memory in float4 broadcasts.
__device__ __forceinline__ int owned(int c, int i) { return (i < 4 ? 0 : 60) + c * 4 + i; }

template <bool VEC>
__device__ __forceinline__ float4 load4(const float* __restrict__ src, long long row,
                                        int rows, int k, int D) {
  float4 r = make_float4(0.f, 0.f, 0.f, 0.f);
  if (row >= rows) return r;
  const float* p = src + row * D + k;
  if (VEC) {
    if (k < D) r = *reinterpret_cast<const float4*>(p);  // D % 4 == 0: all or none
  } else {
    if (k < D) r.x = p[0];
    if (k + 1 < D) r.y = p[1];
    if (k + 2 < D) r.z = p[2];
    if (k + 3 < D) r.w = p[3];
  }
  return r;
}

__device__ __forceinline__ void store_kmajor(float* tile, int row, int kk, float4 v) {
  tile[(kk + 0) * kLd + row] = v.x;
  tile[(kk + 1) * kLd + row] = v.y;
  tile[(kk + 2) * kLd + row] = v.z;
  tile[(kk + 3) * kLd + row] = v.w;
}

// (m, s) <- the logsumexp pair of the union of (m, s) and (m2, s2).
__device__ __forceinline__ void merge_pair(float& m, float& s, float m2, float s2) {
  const float mn = fmaxf(m, m2);
  if (mn == -INFINITY) return;  // both empty
  s = s * expf(m - mn) + s2 * expf(m2 - mn);
  m = mn;
}

template <bool VEC>
__global__ void __launch_bounds__(kThreads, 2)
xent_fwd_kernel(const float* __restrict__ x, const float* __restrict__ w,
                const int* __restrict__ targets, float* __restrict__ out,
                float* __restrict__ part, unsigned int* __restrict__ tickets, int N, int D,
                int V, float softcap) {
  __shared__ __align__(16) float xs[2][kBK * kLd];
  __shared__ __align__(16) float ws[2][kBK * kLd];
  __shared__ float row_m[kBN], row_s[kBN], row_t[kBN];
  __shared__ int row_tgt[kBN];
  __shared__ int is_last;

  const int tid = threadIdx.x;
  const int ty = tid >> 4, tx = tid & 15;
  const int n0 = blockIdx.x * kBN;
  const int splits = gridDim.y, split = blockIdx.y;
  const int tiles = (V + kBV - 1) / kBV;
  const int tile_beg = static_cast<int>(static_cast<long long>(split) * tiles / splits);
  const int tile_end = static_cast<int>(static_cast<long long>(split + 1) * tiles / splits);

  if (tid < kBN) {
    row_m[tid] = -INFINITY;
    row_s[tid] = 0.0f;
    row_t[tid] = 0.0f;
    row_tgt[tid] = n0 + tid < N ? targets[n0 + tid] : -1;
  }

  // Loader coordinates: each thread stages one float4 of x and one of w.
  const int lrow = tid >> 1, lk = (tid & 1) * 4;
  const int nk = (D + kBK - 1) / kBK;

  for (int tile = tile_beg; tile < tile_end; ++tile) {
    const int v0 = tile * kBV;
    float acc[8][8];
#pragma unroll
    for (int i = 0; i < 8; ++i)
#pragma unroll
      for (int j = 0; j < 8; ++j) acc[i][j] = 0.0f;

    float4 xr = load4<VEC>(x, n0 + lrow, N, lk, D);
    float4 wr = load4<VEC>(w, v0 + lrow, V, lk, D);
    store_kmajor(xs[0], lrow, lk, xr);
    store_kmajor(ws[0], lrow, lk, wr);
    __syncthreads();

    for (int kt = 0; kt < nk; ++kt) {
      const int cur = kt & 1;
      if (kt + 1 < nk) {
        xr = load4<VEC>(x, n0 + lrow, N, (kt + 1) * kBK + lk, D);
        wr = load4<VEC>(w, v0 + lrow, V, (kt + 1) * kBK + lk, D);
      }
#pragma unroll
      for (int k = 0; k < kBK; ++k) {
        const float4 a0 = *reinterpret_cast<const float4*>(&xs[cur][k * kLd + ty * 4]);
        const float4 a1 = *reinterpret_cast<const float4*>(&xs[cur][k * kLd + 64 + ty * 4]);
        const float4 b0 = *reinterpret_cast<const float4*>(&ws[cur][k * kLd + tx * 4]);
        const float4 b1 = *reinterpret_cast<const float4*>(&ws[cur][k * kLd + 64 + tx * 4]);
        const float a[8] = {a0.x, a0.y, a0.z, a0.w, a1.x, a1.y, a1.z, a1.w};
        const float b[8] = {b0.x, b0.y, b0.z, b0.w, b1.x, b1.y, b1.z, b1.w};
#pragma unroll
        for (int i = 0; i < 8; ++i)
#pragma unroll
          for (int j = 0; j < 8; ++j) acc[i][j] = fmaf(a[i], b[j], acc[i][j]);
      }
      if (kt + 1 < nk) {
        store_kmajor(xs[cur ^ 1], lrow, lk, xr);
        store_kmajor(ws[cur ^ 1], lrow, lk, wr);
      }
      __syncthreads();
    }

    // Epilogue: fold this tile's logits into each row's running (m, s, t).
    // The 16 threads of a half-warp share rows; the tile has >= 1 valid id.
#pragma unroll
    for (int i = 0; i < 8; ++i) {
      const int r = owned(ty, i);
      float mx = -INFINITY;
#pragma unroll
      for (int j = 0; j < 8; ++j) {
        float l = acc[i][j];
        if (softcap != 0.0f) l = tanhf(l / softcap) * softcap;
        const bool valid = v0 + owned(tx, j) < V;
        acc[i][j] = valid ? l : -INFINITY;
        mx = fmaxf(mx, acc[i][j]);
      }
#pragma unroll
      for (int off = 8; off > 0; off >>= 1)
        mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, off));
      const float m_old = row_m[r];
      const float mn = fmaxf(m_old, mx);
      const int tgt = row_tgt[r];
      float sum = 0.0f;
#pragma unroll
      for (int j = 0; j < 8; ++j) {
        const float l = acc[i][j];
        if (l != -INFINITY) sum += expf(l - mn);
        if (v0 + owned(tx, j) == tgt) row_t[r] += l;  // one thread, one tile
      }
#pragma unroll
      for (int off = 8; off > 0; off >>= 1) sum += __shfl_xor_sync(0xffffffffu, sum, off);
      if (tx == 0) {  // every thread of the half-warp has read m_old (shuffles sync)
        row_s[r] = row_s[r] * expf(m_old - mn) + sum;
        row_m[r] = mn;
      }
    }
  }
  __syncthreads();

  // This split's (m, s, t) per token, then the last CTA of the token block
  // merges every split's in split order.
  if (tid < kBN && n0 + tid < N) {
    const long long at = static_cast<long long>(split) * N + n0 + tid;
    const long long plane = static_cast<long long>(splits) * N;
    part[at] = row_m[tid];
    part[plane + at] = row_s[tid];
    part[2 * plane + at] = row_t[tid];
  }
  __threadfence();
  __syncthreads();
  if (tid == 0) is_last = atomicAdd(&tickets[blockIdx.x], 1u) == static_cast<unsigned>(splits - 1);
  __syncthreads();
  if (!is_last) return;
  __threadfence();
  if (tid < kBN && n0 + tid < N) {
    const long long plane = static_cast<long long>(splits) * N;
    float m = -INFINITY, s = 0.0f, t = 0.0f;
    for (int sp = 0; sp < splits; ++sp) {
      const long long at = static_cast<long long>(sp) * N + n0 + tid;
      merge_pair(m, s, __ldcg(part + at), __ldcg(part + plane + at));
      t += __ldcg(part + 2 * plane + at);
    }
    out[n0 + tid] = m + logf(s) - t;
  }
}

}  // namespace

// x (N, D) f32, w (V, D) f32, targets (N,) int32, all contiguous; out (N,)
// f32; part (3, splits, N) f32 scratch; tickets (ceil(N / 128),) uint32,
// zeroed.  1 <= splits <= ceil(V / 128).  Returns the CUDA error code.
extern "C" int xent_fwd_f32(const void* x, const void* w, const void* targets, void* out,
                            void* part, void* tickets, int N, int D, int V, int splits,
                            float softcap, void* stream) {
  if (N <= 0 || D <= 0 || V <= 0 || splits < 1 || splits > (V + kBV - 1) / kBV)
    return static_cast<int>(cudaErrorInvalidValue);
  const dim3 grid((N + kBN - 1) / kBN, splits);
  const bool vec = D % 4 == 0 && reinterpret_cast<uintptr_t>(x) % 16 == 0 &&
                   reinterpret_cast<uintptr_t>(w) % 16 == 0;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const float* xf = static_cast<const float*>(x);
  const float* wf = static_cast<const float*>(w);
  const int* tf = static_cast<const int*>(targets);
  float* of = static_cast<float*>(out);
  float* pf = static_cast<float*>(part);
  unsigned int* tk = static_cast<unsigned int*>(tickets);
  if (vec)
    xent_fwd_kernel<true><<<grid, kThreads, 0, s>>>(xf, wf, tf, of, pf, tk, N, D, V, softcap);
  else
    xent_fwd_kernel<false><<<grid, kThreads, 0, s>>>(xf, wf, tf, of, pf, tk, N, D, V, softcap);
  return static_cast<int>(cudaGetLastError());
}
