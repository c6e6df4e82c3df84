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
// 2 N V D = 2.15 TFLOP, so the operations bound it.  On the f32 CUDA cores
// (67 TFLOP/s) that is 32.1 ms, a floor no FFMA design passes; this kernel
// runs the products on the TF32 tensor cores (495 TFLOP/s dense) as three
// TF32 products per f32 product (below), 6.45 TFLOP: 13.05 ms at the
// tensor-core peak, against 0.32 ms of bytes.
//
// Numerics, 3xTF32: each f32 operand a is split in registers into
// a_hi = tf32(a) and a_lo = tf32(a - a_hi) (cvt.rna's rule: to nearest,
// ties away), and each k8 slice adds x_lo w_hi, then x_hi w_lo, then
// x_hi w_hi (x_lo w_lo, under 2^-22 of a product, is dropped).  Products of
// two TF32 values are exact, but the tensor cores' own additions cut toward
// zero, so one chain of them over all of D drifts (PERF.md: 12 f32
// epsilons of |x_n| max|w_v| at D = 2,048).  Each depth stage therefore sums
// into a fresh partial, added to the f32 logits by an ordinary f32 add.  The
// CPU model of this order (kernels/xent/ref.py::xent_3xtf32,
// scripts/k6_3xtf32_emulation.py) stays within a few such epsilons of the f32
// plain version on chip_smoke.py's K6 cases, whose gate allows 8.
//
// Design:
// * a CTA of 256 threads (8 warps, 2 along tokens x 4 along the vocab) owns
//   128 tokens and a contiguous range of the vocab (a "split"); it walks
//   its range in tiles of 128 vocab rows, each tile a 128 x 128 x D product
//   on mma.sync.m16n8k8 (TF32 in, f32 accumulate), a warp tile of 64 tokens
//   x 32 vocab rows (4 x 4 mma tiles), two sets of accumulators (the
//   logits and a stage's partial): ~250 registers a thread, one CTA an SM;
// * x and w tiles of depth 64 stream through a 3-stage cp.async ring in
//   shared memory (192 KB), the next tiles in flight while one is
//   multiplied; the ring runs across vocab tiles, so a tile's first stages
//   load during the previous tile's last;
// * both operands are K-major as they lie (x (N, D), w (V, D)), which is
//   what the mma's row.col layout reads: no transpose.  A thread's fragment
//   elements for k and k + 4 sit in adjacent words (the k order inside a k8
//   slice is permuted alike for x and w, so the sum is the same set), read
//   by one 8-byte ld.shared; each row's k8 slices are XOR-swizzled by
//   (row mod 4), so the 16 lanes of a half-warp (4 rows x 4 lanes) hit 32
//   distinct banks;
// * each tile's epilogue folds its logits into the per-token running
//   (m, s, t) kept in shared memory: per warp a row max and sumexp over the
//   4 lanes that share a row (shuffles), the softcap and the vocab-tail mask
//   (ids >= V) applied in the kernel, then the 4 warps along the vocab
//   merged in warp order; w is never padded or copied;
// * each split writes its (m, s, t) per token to a small scratch; the last
//   CTA of a token block to finish (an atomic ticket after a memory fence)
//   merges the splits in split order and writes the loss, so one launch
//   does the whole call and the result does not depend on which CTA ends
//   last;
// * the partial form (xent_part_f32, PART = true) runs the same body on one
//   vocab block of a split unembedding and writes, in place of the loss, the
//   block's merged lse = m + log(s) and its target logit t (0 where the
//   block does not hold the target: a target outside [0, V) matches no
//   column).  The caller combines the blocks' (lse, t) by log-sum-exp;
// * any N (the token tail is zero-filled and bounds-checked), any D (the
//   D tail is zero-filled to the stage), int32 targets; 16-byte copies
//   when D % 4 == 0 and x and w are 16-byte aligned, 4-byte copies else.
// What holds it back (PERF.md): 168 TFLOP/s of TF32 products at Llama's
// shape, a third of the tensor-core peak, from 8 warps an SM issuing
// mma.sync; wgmma from shared memory is the next design.
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace {

constexpr int kBN = 128;       // tokens per CTA
constexpr int kBV = 128;       // vocab rows per tile
constexpr int kBK = 64;        // depth per shared-memory stage
constexpr int kStages = 3;     // cp.async ring
constexpr int kWarpsM = 2;     // warps along the tokens
constexpr int kWarpsV = 4;     // warps along the vocab
constexpr int kThreads = 32 * kWarpsM * kWarpsV;
constexpr int kMT = kBN / 16 / kWarpsM;  // m16 tiles a warp (64 tokens)
constexpr int kNT = kBV / 8 / kWarpsV;   // n8 tiles a warp (32 vocab rows)
constexpr int kStageFloats = (kBN + kBV) * kBK;
constexpr size_t kSmemBytes = sizeof(float) * kStages * kStageFloats;

__device__ __forceinline__ void cp_async16(void* dst, const void* src, int src_bytes) {
  const uint32_t d = static_cast<uint32_t>(__cvta_generic_to_shared(dst));
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(d), "l"(src),
               "r"(src_bytes)
               : "memory");
}
__device__ __forceinline__ void cp_async4(void* dst, const void* src, int src_bytes) {
  const uint32_t d = static_cast<uint32_t>(__cvta_generic_to_shared(dst));
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4, %2;\n" ::"r"(d), "l"(src),
               "r"(src_bytes)
               : "memory");
}
__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}
template <int N> __device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N) : "memory");
}

// f32 -> tf32 by cvt.rna.tf32.f32's rule (to nearest, ties away from zero),
// in two full-rate integer operations: half a unit of the 13 dropped bits
// added to the magnitude, then the bits cut.
__device__ __forceinline__ uint32_t tf32_rna(float a) {
  return (__float_as_uint(a) + 0x1000u) & 0xffffe000u;
}

// a -> (tf32(a), tf32(a - tf32(a))).
__device__ __forceinline__ void split_tf32(float a, uint32_t& hi, uint32_t& lo) {
  hi = tf32_rna(a);
  lo = tf32_rna(a - __uint_as_float(hi));
}

// c (16x8 f32) += a (16x8 tf32, row) * b (8x8 tf32, col).
__device__ __forceinline__ void mma_tf32(float* c, const uint32_t* a, const uint32_t* b) {
  asm("mma.sync.aligned.m16n8k8.row.col.f32.tf32.tf32.f32 {%0, %1, %2, %3}, "
      "{%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b[0]), "r"(b[1]));
}
// c (16x8 f32) = a (16x8 tf32, row) * b (8x8 tf32, col).
__device__ __forceinline__ void mma_tf32_zero(float* c, const uint32_t* a, const uint32_t* b) {
  asm("mma.sync.aligned.m16n8k8.row.col.f32.tf32.tf32.f32 {%0, %1, %2, %3}, "
      "{%4, %5, %6, %7}, {%8, %9}, {%10, %10, %10, %10};\n"
      : "=f"(c[0]), "=f"(c[1]), "=f"(c[2]), "=f"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b[0]), "r"(b[1]), "f"(0.0f));
}

// Word offset in a stage's row of kBK floats of k8 slice `kb` of row `row`:
// slices XOR-swizzled by row mod 4.
__device__ __forceinline__ int swz(int row, int kb) { return ((kb ^ (row & 3)) << 3); }

// Stage rows [r0, r0 + 128) x depth [k0, k0 + kBK) of a (rows, D) f32 matrix
// into dst (128 rows of kBK floats, swizzled); rows >= rows_valid and
// depth >= D are zeros.
template <bool VEC>
__device__ __forceinline__ void load_tile(float* dst, const float* __restrict__ src,
                                          long long r0, int rows_valid, int k0, int D) {
  const int tid = threadIdx.x;
  if (VEC) {
    constexpr int kChunks = kBK / 4;  // 16-byte chunks a row
#pragma unroll
    for (int i = 0; i < 128 * kChunks / kThreads; ++i) {
      const int q = tid + i * kThreads;
      const int row = q / kChunks, c = q % kChunks;
      const int k = k0 + c * 4;
      const bool ok = r0 + row < rows_valid && k < D;
      const float* p = ok ? src + (r0 + row) * D + k : src;
      float* d = dst + row * kBK + swz(row, c >> 1) + (c & 1) * 4;
      cp_async16(d, p, ok ? 16 : 0);
    }
  } else {
#pragma unroll 4
    for (int i = 0; i < 128 * kBK / kThreads; ++i) {
      const int q = tid + i * kThreads;
      const int row = q / kBK, c = q % kBK;
      const int k = k0 + c;
      const bool ok = r0 + row < rows_valid && k < D;
      const float* p = ok ? src + (r0 + row) * D + k : src;
      float* d = dst + row * kBK + swz(row, c >> 3) + (c & 7);
      cp_async4(d, p, ok ? 4 : 0);
    }
  }
}

// (m, s) <- the logsumexp pair of the union of (m, s) and (m2, s2).
__device__ __forceinline__ void merge_pair(float& m, float& s, float m2, float s2) {
  const float mn = fmaxf(m, m2);
  if (mn == -INFINITY) return;  // both empty
  s = s * expf(m - mn) + s2 * expf(m2 - mn);
  m = mn;
}

// PART: write the merged (lse, t) of the vocab range to (out, out_t) in
// place of the loss out = lse - t.
template <bool VEC, bool PART>
__global__ void __launch_bounds__(kThreads, 1)
xent_fwd_kernel(const float* __restrict__ x, const float* __restrict__ w,
                const int* __restrict__ targets, float* __restrict__ out,
                float* __restrict__ out_t, float* __restrict__ part,
                unsigned int* __restrict__ tickets, int N, int D, int V, float softcap) {
  extern __shared__ __align__(16) float smem[];
  __shared__ float row_m[kBN], row_s[kBN], row_t[kBN];
  __shared__ float warp_m[kWarpsV][kBN], warp_s[kWarpsV][kBN];
  __shared__ int row_tgt[kBN];
  __shared__ int is_last;

  const int tid = threadIdx.x;
  const int lane = tid & 31, warp = tid >> 5;
  const int g = lane >> 2, tq = lane & 3;        // mma group and lane in group
  const int wm = warp / kWarpsV, wn = warp % kWarpsV;
  const int n0 = blockIdx.x * kBN;
  const int splits = gridDim.y, split = blockIdx.y;
  const int tiles = (V + kBV - 1) / kBV;
  const int tile_beg = static_cast<int>(static_cast<long long>(split) * tiles / splits);
  const int tile_end = static_cast<int>(static_cast<long long>(split + 1) * tiles / splits);

  if (tid < kBN) {
    row_m[tid] = -INFINITY;
    row_s[tid] = 0.0f;
    row_t[tid] = 0.0f;
    // a target outside [0, V) matches no column, the masked tail's included
    const int tg = n0 + tid < N ? targets[n0 + tid] : -1;
    row_tgt[tid] = tg >= 0 && tg < V ? tg : -1;
  }

  const int nk = (D + kBK - 1) / kBK;
  const int steps = (tile_end - tile_beg) * nk;  // (vocab tile, depth) pairs
  auto load_step = [&](int step) {
    float* st = smem + (step % kStages) * kStageFloats;
    const int v0 = (tile_beg + step / nk) * kBV, k0 = (step % nk) * kBK;
    load_tile<VEC>(st, x, n0, N, k0, D);
    load_tile<VEC>(st + kBN * kBK, w, v0, V, k0, D);
  };
#pragma unroll
  for (int s = 0; s < kStages - 1; ++s) {
    if (s < steps) load_step(s);
    cp_async_commit();
  }

  float acc[kMT][kNT][4], stage_sum[kMT][kNT][4];
#pragma unroll
  for (int i = 0; i < kMT; ++i)
#pragma unroll
    for (int j = 0; j < kNT; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) acc[i][j][e] = 0.0f;

  // A thread's rows: x rows wm*64 + 16 mi + g (+8), w rows wn*32 + 8 ni + g;
  // every one is g mod 4, so the swizzle of slice kb is the same for all.
  const int xrow0 = wm * 16 * kMT + g, wrow0 = wn * 8 * kNT + g;

  for (int step = 0; step < steps; ++step) {
    cp_async_wait<kStages - 2>();
    __syncthreads();  // this step's stage has landed; the last one is free
    if (step + kStages - 1 < steps) load_step(step + kStages - 1);
    cp_async_commit();

    const float* xs = smem + (step % kStages) * kStageFloats;
    const float* ws = xs + kBN * kBK;
#pragma unroll
    for (int kb = 0; kb < kBK / 8; ++kb) {
      const int off = swz(g, kb) + 2 * tq;
      uint32_t bh[kNT][2], bl[kNT][2];
#pragma unroll
      for (int ni = 0; ni < kNT; ++ni) {
        const float2 b = *reinterpret_cast<const float2*>(ws + (wrow0 + 8 * ni) * kBK + off);
        split_tf32(b.x, bh[ni][0], bl[ni][0]);
        split_tf32(b.y, bh[ni][1], bl[ni][1]);
      }
#pragma unroll
      for (int mi = 0; mi < kMT; ++mi) {
        const float2 a0 = *reinterpret_cast<const float2*>(xs + (xrow0 + 16 * mi) * kBK + off);
        const float2 a1 =
            *reinterpret_cast<const float2*>(xs + (xrow0 + 16 * mi + 8) * kBK + off);
        uint32_t ah[4], al[4];
        split_tf32(a0.x, ah[0], al[0]);
        split_tf32(a1.x, ah[1], al[1]);
        split_tf32(a0.y, ah[2], al[2]);
        split_tf32(a1.y, ah[3], al[3]);
#pragma unroll
        for (int ni = 0; ni < kNT; ++ni) {
          if (kb == 0)
            mma_tf32_zero(stage_sum[mi][ni], al, bh[ni]);
          else
            mma_tf32(stage_sum[mi][ni], al, bh[ni]);
        }
#pragma unroll
        for (int ni = 0; ni < kNT; ++ni) mma_tf32(stage_sum[mi][ni], ah, bl[ni]);
#pragma unroll
        for (int ni = 0; ni < kNT; ++ni) mma_tf32(stage_sum[mi][ni], ah, bh[ni]);
      }
    }
    // The stage's partial joins the running logits by an f32 add, rounded
    // to nearest: the tensor cores' own additions cut toward zero, so a
    // chain of them runs over one stage only.
#pragma unroll
    for (int i = 0; i < kMT; ++i)
#pragma unroll
      for (int j = 0; j < kNT; ++j)
#pragma unroll
        for (int e = 0; e < 4; ++e) acc[i][j][e] += stage_sum[i][j][e];

    if (step % nk != nk - 1) continue;
    // Epilogue of a vocab tile: fold its logits into each row's (m, s, t).
    // acc[mi][ni][e]: row wm*64 + 16 mi + g + 8 (e >> 1), column
    // wn*32 + 8 ni + 2 tq + (e & 1) of the tile.
    const int v0 = (tile_beg + step / nk) * kBV;
#pragma unroll
    for (int mi = 0; mi < kMT; ++mi) {
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        const int r = wm * 16 * kMT + 16 * mi + g + 8 * h;
        const int tgt = row_tgt[r];
        float mx = -INFINITY;
#pragma unroll
        for (int ni = 0; ni < kNT; ++ni) {
#pragma unroll
          for (int c = 0; c < 2; ++c) {
            const int v = v0 + wn * 8 * kNT + 8 * ni + 2 * tq + c;
            float l = acc[mi][ni][2 * h + c];
            if (softcap != 0.0f) l = tanhf(l / softcap) * softcap;
            l = v < V ? l : -INFINITY;
            if (v == tgt) row_t[r] += l;  // one thread of the CTA, one tile
            acc[mi][ni][2 * h + c] = l;
            mx = fmaxf(mx, l);
          }
        }
        mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, 1));
        mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, 2));
        float sum = 0.0f;
        if (mx != -INFINITY) {
#pragma unroll
          for (int ni = 0; ni < kNT; ++ni)
#pragma unroll
            for (int c = 0; c < 2; ++c) sum += expf(acc[mi][ni][2 * h + c] - mx);
        }
        sum += __shfl_xor_sync(0xffffffffu, sum, 1);
        sum += __shfl_xor_sync(0xffffffffu, sum, 2);
        if (tq == 0) {
          warp_m[wn][r] = mx;
          warp_s[wn][r] = sum;
        }
      }
    }
    __syncthreads();
    if (tid < kBN) {
      float m = row_m[tid], s = row_s[tid];
#pragma unroll
      for (int q = 0; q < kWarpsV; ++q) merge_pair(m, s, warp_m[q][tid], warp_s[q][tid]);
      row_m[tid] = m;
      row_s[tid] = s;
    }
#pragma unroll
    for (int i = 0; i < kMT; ++i)
#pragma unroll
      for (int j = 0; j < kNT; ++j)
#pragma unroll
        for (int e = 0; e < 4; ++e) acc[i][j][e] = 0.0f;
  }
  cp_async_wait<0>();
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
    if (PART) {
      out[n0 + tid] = m + logf(s);
      out_t[n0 + tid] = t;
    } else {
      out[n0 + tid] = m + logf(s) - t;
    }
  }
}

template <bool VEC, bool PART>
int launch(const float* x, const float* w, const int* t, float* out, float* out_t,
           float* part, unsigned int* tickets, int N, int D, int V, int splits,
           float softcap, cudaStream_t s) {
  cudaError_t e = cudaFuncSetAttribute(xent_fwd_kernel<VEC, PART>,
                                       cudaFuncAttributeMaxDynamicSharedMemorySize,
                                       static_cast<int>(kSmemBytes));
  if (e != cudaSuccess) return static_cast<int>(e);
  const dim3 grid((N + kBN - 1) / kBN, splits);
  xent_fwd_kernel<VEC, PART><<<grid, kThreads, kSmemBytes, s>>>(x, w, t, out, out_t, part,
                                                                tickets, N, D, V, softcap);
  return static_cast<int>(cudaGetLastError());
}

template <bool PART>
int entry(const void* x, const void* w, const void* targets, void* out, void* out_t,
          void* part, void* tickets, int N, int D, int V, int splits, float softcap,
          void* stream) {
  if (N <= 0 || D <= 0 || V <= 0 || splits < 1 || splits > (V + kBV - 1) / kBV)
    return static_cast<int>(cudaErrorInvalidValue);
  const bool vec = D % 4 == 0 && reinterpret_cast<uintptr_t>(x) % 16 == 0 &&
                   reinterpret_cast<uintptr_t>(w) % 16 == 0;
  const float* xf = static_cast<const float*>(x);
  const float* wf = static_cast<const float*>(w);
  const int* tf = static_cast<const int*>(targets);
  float* of = static_cast<float*>(out);
  float* otf = static_cast<float*>(out_t);
  float* pf = static_cast<float*>(part);
  unsigned int* tk = static_cast<unsigned int*>(tickets);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  return vec ? launch<true, PART>(xf, wf, tf, of, otf, pf, tk, N, D, V, splits, softcap, s)
             : launch<false, PART>(xf, wf, tf, of, otf, pf, tk, N, D, V, splits, softcap, s);
}

}  // namespace

// x (N, D) f32, w (V, D) f32, targets (N,) int32, all contiguous; out (N,)
// f32; part (3, splits, N) f32 scratch; tickets (ceil(N / 128),) uint32,
// zeroed.  1 <= splits <= ceil(V / 128).  Returns the CUDA error code.
extern "C" int xent_fwd_f32(const void* x, const void* w, const void* targets, void* out,
                            void* part, void* tickets, int N, int D, int V, int splits,
                            float softcap, void* stream) {
  return entry<false>(x, w, targets, out, nullptr, part, tickets, N, D, V, splits, softcap,
                      stream);
}

// The partial form on one vocab block w (V, D) of a split unembedding, with
// block-local int32 targets (any value; one outside [0, V) leaves t = 0):
// lse (N,) = log sum_v exp(l[n, v]) and t (N,) = l[n, targets[n]], f32.
// The other arguments as xent_fwd_f32's.
extern "C" int xent_part_f32(const void* x, const void* w, const void* targets, void* lse,
                             void* t, void* part, void* tickets, int N, int D, int V,
                             int splits, float softcap, void* stream) {
  return entry<true>(x, w, targets, lse, t, part, tickets, N, D, V, splits, softcap, stream);
}
