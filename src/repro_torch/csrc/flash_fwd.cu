// K5: flash-attention forward, GQA, causal / sliding-window / tanh softcap.
//
// Replaces the TPU kernel repro/kernels/flash/kernel.py::_kernel (entry point
// flash_attention_fwd, pallas_call at kernel.py:112).  Same function: for
// each query row, softmax over the keys it may see (causal: key <= query;
// window w > 0: key > query - w) of scale * q.k, optionally tanh-softcapped,
// times V; the online softmax keeps a running (max m, sum l, acc) in f32 and
// the (S x T) score matrix never reaches device memory.  A row with no
// visible key writes zeros (kernel.py:72-75).  Query row i sits at position
// q_offset + i (a data row's span of a sequence split over the data axes;
// 0 for a whole sequence): the key range and the mask take the offset
// (flash_mask.cuh, shared by both kernels), the q and o rows stay local.
//
// What bounds it on an H100: at the Llama-3.2-1B prefill shapes (B=1,
// S <= 1,024, H=32, K=8, h=64, bf16) a call reads q/k/v once (~5 MB at
// S=1,000) and does ~2 S^2/2 H h multiply-adds, so the operations bound it
// (about 4 us of bf16 tensor-core time against 1.5 us of bytes at S=1,000).
//
// Two kernels, one CTA of 128 threads per (batch*query head, block of 64
// query rows), the heaviest causal blocks launched first; GQA without a
// copy (query head hq reads KV head hq / G in place); inputs (B, S, n, h)
// with any batch, row and head strides and a contiguous head dim, so views
// of a projection are read as they are; key blocks wholly above the
// diagonal or before the window skipped; ragged tails of S and T masked.
//
// * bf16 (flash_fwd_tc_kernel): both products on the tensor cores,
//   mma.sync.m16n8k16 with bf16 operands and f32 accumulation; each warp
//   owns 16 query rows.  Q, K and V stay bf16 in shared memory (rows padded
//   by 16 bytes, so ldmatrix reads are free of bank conflicts); K/V blocks
//   are double-buffered with cp.async, the next block loading while this
//   one is multiplied (scalar loads into the same tiles when a pointer or
//   stride is not 16-byte aligned).  The online softmax runs in f32 in
//   registers on the accumulator fragments (exp2 of log2e-scaled scores
//   by ex2.approx); P is rounded to bf16 as the A operand of PV, the one
//   rounding the f32 kernel does not have.  wgmma
//   (a 64-row warpgroup product from shared-memory descriptors) and TMA are
//   the follow-up.
// * f32 (flash_fwd_kernel): products in f32 on the CUDA cores, two threads
//   per query row, Q/K/V tiles in shared memory as f32 (row stride h+4:
//   16-byte float4 reads, banks staggered), probabilities through shared
//   memory between the two products.  TF32 would miss the f32 gates.
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

#include <type_traits>

#include "flash_mask.cuh"

namespace {

constexpr int kBQ = 64;        // query rows per CTA
constexpr int kThreads = 128;  // f32: two threads a query row; bf16: a warp a 16 rows

__device__ __forceinline__ float to_f32(float v) { return v; }

template <typename T> __device__ __forceinline__ T from_f32(float v);
template <> __device__ __forceinline__ float from_f32<float>(float v) { return v; }

struct Strides {  // in elements; the head dim is contiguous
  long long b, s, n;
};

template <int HD> __host__ __device__ constexpr int key_block() { return HD <= 128 ? 64 : 32; }
template <int HD> __host__ __device__ constexpr int ld() { return HD + 4; }

template <int HD> __host__ __device__ constexpr size_t smem_bytes() {
  return sizeof(float) * (static_cast<size_t>(kBQ + 2 * key_block<HD>()) * ld<HD>() +
                          static_cast<size_t>(kBQ) * (key_block<HD>() + 1));
}

template <typename T, int HD>
__device__ __forceinline__ void stage(float* dst, const T* __restrict__ src, long long row_stride,
                                      int rows, int first, int limit) {
  for (int e = threadIdx.x; e < rows * HD; e += kThreads) {
    const int r = e / HD, d = e % HD;
    const int i = first + r;
    dst[r * ld<HD>() + d] = i < limit ? to_f32(src[i * row_stride + d]) : 0.0f;
  }
}

template <typename T, int HD>
__global__ void __launch_bounds__(kThreads)
flash_fwd_kernel(const T* __restrict__ q, const T* __restrict__ k, const T* __restrict__ v,
                 T* __restrict__ o, Strides qs, Strides ks, Strides vs, Strides os, int S,
                 int T_, int H, int G, float scale, int causal, int window, int q_offset,
                 float softcap) {
  constexpr int BK = key_block<HD>();
  constexpr int LD = ld<HD>();
  constexpr int LDP = BK + 1;
  constexpr int HALF = HD / 2;
  extern __shared__ float4 smem4[];
  float* Qs = reinterpret_cast<float*>(smem4);
  float* Ks = Qs + kBQ * LD;
  float* Vs = Ks + BK * LD;
  float* Ps = Vs + BK * LD;

  const int qb = gridDim.x - 1 - blockIdx.x;  // heaviest causal blocks first
  const int b = blockIdx.y / H, hq = blockIdx.y % H, hk = hq / G;
  const int q0 = qb * kBQ;
  const int row = threadIdx.x >> 1, half = threadIdx.x & 1;
  const int qi = q0 + row;

  stage<T, HD>(Qs, q + b * qs.b + hq * qs.n, qs.s, kBQ, q0, S);
  const T* kb = k + b * ks.b + hk * ks.n;
  const T* vb = v + b * vs.b + hk * vs.n;

  const int kend = fm::key_end(T_, q_offset, q0, kBQ, causal);
  const int kbeg = fm::key_begin(q_offset, q0, window, BK);

  float m = -INFINITY, l = 0.0f;
  float acc[HALF];
#pragma unroll
  for (int i = 0; i < HALF; ++i) acc[i] = 0.0f;

  for (int k0 = kbeg; k0 < kend; k0 += BK) {
    __syncthreads();  // the previous tiles are consumed
    stage<T, HD>(Ks, kb, ks.s, BK, k0, T_);
    stage<T, HD>(Vs, vb, vs.s, BK, k0, T_);
    __syncthreads();

    // scores of keys j = half + 2c
    float sc[BK / 2];
#pragma unroll
    for (int c = 0; c < BK / 2; ++c) sc[c] = 0.0f;
    for (int d = 0; d < HD; d += 4) {
      const float4 qv = *reinterpret_cast<const float4*>(&Qs[row * LD + d]);
#pragma unroll
      for (int c = 0; c < BK / 2; ++c) {
        const float4 kv = *reinterpret_cast<const float4*>(&Ks[(half + 2 * c) * LD + d]);
        float s = sc[c];
        s = fmaf(qv.x, kv.x, s);
        s = fmaf(qv.y, kv.y, s);
        s = fmaf(qv.z, kv.z, s);
        s = fmaf(qv.w, kv.w, s);
        sc[c] = s;
      }
    }
    float mblk = -INFINITY;
#pragma unroll
    for (int c = 0; c < BK / 2; ++c) {
      const int kj = k0 + half + 2 * c;
      float s = sc[c] * scale;
      if (softcap != 0.0f) s = tanhf(s / softcap) * softcap;
      sc[c] = fm::visible(kj, qi, T_, q_offset, causal, window) ? s : -INFINITY;
      mblk = fmaxf(mblk, sc[c]);
    }
    mblk = fmaxf(mblk, __shfl_xor_sync(0xffffffffu, mblk, 1));
    const float mnew = fmaxf(m, mblk);
    const float alpha = (m == -INFINITY) ? 0.0f : expf(m - mnew);
    float lsum = 0.0f;
#pragma unroll
    for (int c = 0; c < BK / 2; ++c) {
      const float p = (sc[c] == -INFINITY) ? 0.0f : expf(sc[c] - mnew);
      Ps[row * LDP + half + 2 * c] = p;
      lsum += p;
    }
    lsum += __shfl_xor_sync(0xffffffffu, lsum, 1);
    l = l * alpha + lsum;
    m = mnew;
#pragma unroll
    for (int i = 0; i < HALF; ++i) acc[i] *= alpha;
    __syncwarp();  // both threads of a row wrote its probabilities

    for (int j = 0; j < BK; ++j) {
      const float p = Ps[row * LDP + j];
      const float* vr = &Vs[j * LD + half * HALF];
#pragma unroll
      for (int d = 0; d < HALF; d += 4) {
        const float4 vv = *reinterpret_cast<const float4*>(vr + d);
        acc[d] = fmaf(p, vv.x, acc[d]);
        acc[d + 1] = fmaf(p, vv.y, acc[d + 1]);
        acc[d + 2] = fmaf(p, vv.z, acc[d + 2]);
        acc[d + 3] = fmaf(p, vv.w, acc[d + 3]);
      }
    }
  }

  if (qi < S) {
    const float safe = l == 0.0f ? 1.0f : l;  // a row with no visible key writes zeros
    T* orow = o + b * os.b + qi * os.s + hq * os.n + half * HALF;
#pragma unroll
    for (int i = 0; i < HALF; ++i) orow[i] = from_f32<T>(acc[i] / safe);
  }
}

// ---- bf16: tensor cores, cp.async double buffering ----------------------

using bf16 = __nv_bfloat16;
constexpr float kLog2e = 1.4426950408889634f;

// K/V blocks in flight.  Deeper pipelines and 128-key blocks measured
// slower on the H100 at Llama's shapes (fewer CTAs an SM), as did two
// 16-row m tiles a warp, 8 warps a 128-row block and Q held in registers
// (PERF.md).
constexpr int kStages = 2;

// The tiling of one head dim: kBQ query rows a CTA of kThreads (a warp per
// 16 rows), BK keys a block.
template <int HD> struct Tc {
  static constexpr int BK = HD <= 128 ? 64 : 32;
  // bf16 elements a shared-memory row: 16 bytes of padding put the eight
  // rows an ldmatrix reads in eight distinct 16-byte bank groups.
  static constexpr int LD = HD + 8;
  // Q, then kStages stages of K and of V.
  static constexpr size_t SMEM = sizeof(bf16) * static_cast<size_t>(kBQ + 2 * kStages * BK) * LD;
};

__device__ __forceinline__ void cp_async16(void* dst, const void* src, int src_bytes) {
  const uint32_t d = static_cast<uint32_t>(__cvta_generic_to_shared(dst));
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(d), "l"(src),
               "r"(src_bytes)
               : "memory");
}
__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}
template <int N> __device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N) : "memory");
}

__device__ __forceinline__ void ldsm_x4(uint32_t* r, const bf16* p) {
  const uint32_t a = static_cast<uint32_t>(__cvta_generic_to_shared(p));
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0, %1, %2, %3}, [%4];\n"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
               : "r"(a)
               : "memory");
}
__device__ __forceinline__ void ldsm_x4_trans(uint32_t* r, const bf16* p) {
  const uint32_t a = static_cast<uint32_t>(__cvta_generic_to_shared(p));
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0, %1, %2, %3}, [%4];\n"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
               : "r"(a)
               : "memory");
}

// c (16x8 f32) += a (16x16 bf16, row) * b (16x8 bf16, col).
__device__ __forceinline__ void mma_bf16(float* c, const uint32_t* a, uint32_t b0,
                                         uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 {%0, %1, %2, %3}, "
      "{%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// 2^x in one MUFU.EX2 (relative error ~2^-22; results under 2^-126 flush
// to zero, weights that vanish beside the row's largest, which is 1).
// exp2f wraps the same instruction in denormal handling that showed in the
// kernel's time at Llama's shapes (PERF.md).
__device__ __forceinline__ float ex2(float x) {
  float y;
  asm("ex2.approx.ftz.f32 %0, %1;" : "=f"(y) : "f"(x));
  return y;
}

// Two f32 rounded to bf16 in one register, lo in the low half (the element
// of the lower column, as mma's fragments hold them).
__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  __nv_bfloat162 h = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<uint32_t*>(&h);
}

// Rows [first, first + rows) of a (., HD) bf16 operand into a padded tile;
// rows at or past `limit` are zeros.  16-byte cp.async copies (zero-filled
// past the limit) when the source is aligned, scalar loads otherwise.
template <int HD>
__device__ __forceinline__ void stage_tc(bf16* dst, const bf16* __restrict__ src,
                                         long long row_stride, int rows, int first,
                                         int limit, bool aligned) {
  constexpr int CH = HD / 8;  // 16-byte chunks a row
  for (int c = threadIdx.x; c < rows * CH; c += kThreads) {
    const int r = c / CH, d = (c % CH) * 8;
    const int i = first + r;
    bf16* dp = dst + r * Tc<HD>::LD + d;
    if (aligned) {
      cp_async16(dp, src + static_cast<long long>(i < limit ? i : 0) * row_stride + d,
                 i < limit ? 16 : 0);
    } else {
#pragma unroll
      for (int e = 0; e < 8; ++e)
        dp[e] = i < limit ? src[static_cast<long long>(i) * row_stride + d + e]
                          : __float2bfloat16_rn(0.0f);
    }
  }
}

template <int HD>
__global__ void __launch_bounds__(kThreads)
flash_fwd_tc_kernel(const bf16* __restrict__ q, const bf16* __restrict__ k,
                    const bf16* __restrict__ v, bf16* __restrict__ o, Strides qs,
                    Strides ks, Strides vs, Strides os, int S, int T_, int H, int G,
                    float scale, int causal, int window, int q_offset, float softcap,
                    int aligned) {
  constexpr int BK = Tc<HD>::BK, LD = Tc<HD>::LD;
  constexpr int NT = BK / 8;  // 8-key column tiles of the scores
  constexpr int DT = HD / 8;  // 8-wide column tiles of the output
  extern __shared__ uint4 smem_tc[];
  bf16* Qs = reinterpret_cast<bf16*>(smem_tc);
  bf16* Ks = Qs + kBQ * LD;  // kStages stages of BK rows
  bf16* Vs = Ks + kStages * BK * LD;

  const int qb = gridDim.x - 1 - blockIdx.x;  // heaviest causal blocks first
  const int b = blockIdx.y / H, hq = blockIdx.y % H, hk = hq / G;
  const int q0 = qb * kBQ;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int g = lane >> 2, tq = lane & 3;  // fragment row and column pair
  const int r0 = q0 + warp * 16 + g;       // this thread's rows: r0 and r0 + 8
  const bf16* kb = k + b * ks.b + hk * ks.n;
  const bf16* vb = v + b * vs.b + hk * vs.n;

  const int kend = fm::key_end(T_, q_offset, q0, kBQ, causal);
  const int kbeg = fm::key_begin(q_offset, q0, window, BK);
  const int nblk = kend > kbeg ? (kend - kbeg + BK - 1) / BK : 0;

  // Q and the first kStages - 1 key blocks, one commit group each (empty
  // groups past the last block keep the count uniform).
  stage_tc<HD>(Qs, q + b * qs.b + hq * qs.n, qs.s, kBQ, q0, S, aligned);
#pragma unroll
  for (int i = 0; i < kStages - 1; ++i) {
    if (i < nblk) {
      stage_tc<HD>(Ks + i * BK * LD, kb, ks.s, BK, kbeg + i * BK, T_, aligned);
      stage_tc<HD>(Vs + i * BK * LD, vb, vs.s, BK, kbeg + i * BK, T_, aligned);
    }
    cp_async_commit();
  }

  float acc[DT][4];
#pragma unroll
  for (int j = 0; j < DT; ++j) acc[j][0] = acc[j][1] = acc[j][2] = acc[j][3] = 0.0f;
  float m[2] = {-INFINITY, -INFINITY};  // running max, log2 units
  float l[2] = {0.0f, 0.0f};
  const float qk_scale = scale * (softcap != 0.0f ? 1.0f : kLog2e);

  for (int blk = 0; blk < nblk; ++blk) {
    const int k0 = kbeg + blk * BK;
    cp_async_wait<kStages - 2>();  // this block has landed
    // Every thread's copies are visible, and every warp is done with the
    // stage the next copy overwrites (the one used kStages - 1 blocks ago).
    __syncthreads();
    {
      const int nxt = blk + kStages - 1;  // loads while this block is used
      if (nxt < nblk) {
        stage_tc<HD>(Ks + (nxt % kStages) * BK * LD, kb, ks.s, BK, kbeg + nxt * BK, T_,
                     aligned);
        stage_tc<HD>(Vs + (nxt % kStages) * BK * LD, vb, vs.s, BK, kbeg + nxt * BK, T_,
                     aligned);
      }
      cp_async_commit();
    }
    const bf16* Kt = Ks + (blk % kStages) * BK * LD;
    const bf16* Vt = Vs + (blk % kStages) * BK * LD;

    // scores: this warp's 16 rows x BK keys
    float sc[NT][4];
#pragma unroll
    for (int j = 0; j < NT; ++j) sc[j][0] = sc[j][1] = sc[j][2] = sc[j][3] = 0.0f;
#pragma unroll
    for (int kk = 0; kk < HD / 16; ++kk) {
      uint32_t a[4];
      ldsm_x4(a, Qs + (warp * 16 + (lane & 15)) * LD + kk * 16 + (lane >> 4) * 8);
#pragma unroll
      for (int j = 0; j < NT; j += 2) {
        uint32_t bk[4];
        ldsm_x4(bk, Kt + (j * 8 + (lane >> 4) * 8 + (lane & 7)) * LD + kk * 16 +
                        ((lane >> 3) & 1) * 8);
        mma_bf16(sc[j], a, bk[0], bk[1]);
        mma_bf16(sc[j + 1], a, bk[2], bk[3]);
      }
    }

    // scale, softcap (on the f32 scores, before the mask and the max), mask
    const bool edge = fm::edge(k0, BK, T_, q_offset, q0, kBQ, causal, window);
    float mx[2] = {-INFINITY, -INFINITY};
#pragma unroll
    for (int j = 0; j < NT; ++j) {
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        float x = sc[j][e] * qk_scale;
        if (softcap != 0.0f) x = tanhf(x / softcap) * softcap * kLog2e;
        if (edge) {
          const int kj = k0 + j * 8 + 2 * tq + (e & 1);
          const int qi = r0 + (e >> 1) * 8;
          x = fm::visible(kj, qi, T_, q_offset, causal, window) ? x : -INFINITY;
        }
        sc[j][e] = x;
        mx[e >> 1] = fmaxf(mx[e >> 1], x);
      }
    }
    float alpha[2], rs[2] = {0.0f, 0.0f};
#pragma unroll
    for (int r = 0; r < 2; ++r) {  // the four threads of a row hold its keys
      mx[r] = fmaxf(mx[r], __shfl_xor_sync(0xffffffffu, mx[r], 1));
      mx[r] = fmaxf(mx[r], __shfl_xor_sync(0xffffffffu, mx[r], 2));
      const float mnew = fmaxf(m[r], mx[r]);
      alpha[r] = m[r] == -INFINITY ? 0.0f : ex2(m[r] - mnew);
      m[r] = mnew;
    }
    // probabilities, rounded to bf16 as PV's A operand (two 8-key tiles
    // make one 16-key k step)
    uint32_t pa[NT / 2][4];
#pragma unroll
    for (int j = 0; j < NT; ++j) {
      float p[4];
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        p[e] = sc[j][e] == -INFINITY ? 0.0f : ex2(sc[j][e] - m[e >> 1]);
        rs[e >> 1] += p[e];
      }
      pa[j / 2][(j & 1) * 2] = pack_bf16(p[0], p[1]);
      pa[j / 2][(j & 1) * 2 + 1] = pack_bf16(p[2], p[3]);
    }
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      rs[r] += __shfl_xor_sync(0xffffffffu, rs[r], 1);
      rs[r] += __shfl_xor_sync(0xffffffffu, rs[r], 2);
      l[r] = l[r] * alpha[r] + rs[r];
    }
#pragma unroll
    for (int j = 0; j < DT; ++j) {
      acc[j][0] *= alpha[0];
      acc[j][1] *= alpha[0];
      acc[j][2] *= alpha[1];
      acc[j][3] *= alpha[1];
    }
#pragma unroll
    for (int kk = 0; kk < BK / 16; ++kk) {
#pragma unroll
      for (int j = 0; j < DT; j += 2) {
        uint32_t bv[4];
        ldsm_x4_trans(bv, Vt + (kk * 16 + (lane & 7) + ((lane >> 3) & 1) * 8) * LD +
                              j * 8 + (lane >> 4) * 8);
        mma_bf16(acc[j], pa[kk], bv[0], bv[1]);
        mma_bf16(acc[j + 1], pa[kk], bv[2], bv[3]);
      }
    }
  }
  cp_async_wait<0>();

#pragma unroll
  for (int r = 0; r < 2; ++r) {
    const int qi = r0 + r * 8;
    if (qi >= S) continue;
    const float safe = l[r] == 0.0f ? 1.0f : l[r];  // a row with no visible key writes zeros
    bf16* orow = o + b * os.b + qi * os.s + hq * os.n + 2 * tq;
#pragma unroll
    for (int j = 0; j < DT; ++j)
      *reinterpret_cast<__nv_bfloat162*>(orow + j * 8) =
          __floats2bfloat162_rn(acc[j][2 * r] / safe, acc[j][2 * r + 1] / safe);
  }
}

template <int HD>
int launch_tc(const void* q, const void* k, const void* v, void* o, int B, int S, int T_,
              int H, int K, Strides qs, Strides ks, Strides vs, Strides os, float scale,
              int causal, int window, int q_offset, float softcap, void* stream) {
  const size_t smem = Tc<HD>::SMEM;
  cudaError_t e = cudaFuncSetAttribute(flash_fwd_tc_kernel<HD>,
                                       cudaFuncAttributeMaxDynamicSharedMemorySize,
                                       static_cast<int>(smem));
  if (e != cudaSuccess) return static_cast<int>(e);
  // cp.async moves 16 bytes: every base and row/batch/head stride must keep
  // each row's 8-element chunks 16-byte aligned.
  const uintptr_t bases = reinterpret_cast<uintptr_t>(q) | reinterpret_cast<uintptr_t>(k) |
                          reinterpret_cast<uintptr_t>(v);
  const long long strides = qs.b | qs.s | qs.n | ks.b | ks.s | ks.n | vs.b | vs.s | vs.n;
  const int aligned = (bases % 16 == 0) && (strides % 8 == 0);
  const dim3 grid((S + kBQ - 1) / kBQ, B * H);
  flash_fwd_tc_kernel<HD><<<grid, kThreads, smem, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const bf16*>(q), static_cast<const bf16*>(k), static_cast<const bf16*>(v),
      static_cast<bf16*>(o), qs, ks, vs, os, S, T_, H, H / K, scale, causal, window, q_offset,
      softcap, aligned);
  return static_cast<int>(cudaGetLastError());
}

template <typename T, int HD>
int launch_hd(const void* q, const void* k, const void* v, void* o, int B, int S, int T_,
              int H, int K, Strides qs, Strides ks, Strides vs, Strides os, float scale,
              int causal, int window, int q_offset, float softcap, void* stream) {
  if constexpr (std::is_same<T, bf16>::value) {
    return launch_tc<HD>(q, k, v, o, B, S, T_, H, K, qs, ks, vs, os, scale, causal, window,
                         q_offset, softcap, stream);
  } else {
    const size_t smem = smem_bytes<HD>();
    cudaError_t e = cudaFuncSetAttribute(flash_fwd_kernel<T, HD>,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize,
                                         static_cast<int>(smem));
    if (e != cudaSuccess) return static_cast<int>(e);
    const dim3 grid((S + kBQ - 1) / kBQ, B * H);
    flash_fwd_kernel<T, HD><<<grid, kThreads, smem, static_cast<cudaStream_t>(stream)>>>(
        static_cast<const T*>(q), static_cast<const T*>(k), static_cast<const T*>(v),
        static_cast<T*>(o), qs, ks, vs, os, S, T_, H, H / K, scale, causal, window, q_offset,
        softcap);
    return static_cast<int>(cudaGetLastError());
  }
}

template <typename T>
int launch(const void* q, const void* k, const void* v, void* o, int B, int S, int T_, int H,
           int K, int hd, long long qsb, long long qss, long long qsn, long long ksb,
           long long kss, long long ksn, long long vsb, long long vss, long long vsn,
           long long osb, long long oss, long long osn, float scale, int causal, int window,
           int q_offset, float softcap, void* stream) {
  const Strides qs{qsb, qss, qsn}, ks{ksb, kss, ksn}, vs{vsb, vss, vsn}, os{osb, oss, osn};
  switch (hd) {
    case 32:
      return launch_hd<T, 32>(q, k, v, o, B, S, T_, H, K, qs, ks, vs, os, scale, causal,
                              window, q_offset, softcap, stream);
    case 64:
      return launch_hd<T, 64>(q, k, v, o, B, S, T_, H, K, qs, ks, vs, os, scale, causal,
                              window, q_offset, softcap, stream);
    case 128:
      return launch_hd<T, 128>(q, k, v, o, B, S, T_, H, K, qs, ks, vs, os, scale, causal,
                               window, q_offset, softcap, stream);
    case 256:
      return launch_hd<T, 256>(q, k, v, o, B, S, T_, H, K, qs, ks, vs, os, scale, causal,
                               window, q_offset, softcap, stream);
    default:
      return static_cast<int>(cudaErrorInvalidValue);
  }
}

}  // namespace

extern "C" int flash_fwd_f32(const void* q, const void* k, const void* v, void* o, int B,
                             int S, int T_, int H, int K, int hd, long long qsb, long long qss,
                             long long qsn, long long ksb, long long kss, long long ksn,
                             long long vsb, long long vss, long long vsn, long long osb,
                             long long oss, long long osn, float scale, int causal,
                             int window, int q_offset, float softcap, void* stream) {
  return launch<float>(q, k, v, o, B, S, T_, H, K, hd, qsb, qss, qsn, ksb, kss, ksn, vsb,
                       vss, vsn, osb, oss, osn, scale, causal, window, q_offset, softcap,
                       stream);
}

extern "C" int flash_fwd_bf16(const void* q, const void* k, const void* v, void* o, int B,
                              int S, int T_, int H, int K, int hd, long long qsb, long long qss,
                              long long qsn, long long ksb, long long kss, long long ksn,
                              long long vsb, long long vss, long long vsn, long long osb,
                              long long oss, long long osn, float scale, int causal,
                              int window, int q_offset, float softcap, void* stream) {
  return launch<__nv_bfloat16>(q, k, v, o, B, S, T_, H, K, hd, qsb, qss, qsn, ksb, kss, ksn,
                               vsb, vss, vsn, osb, oss, osn, scale, causal, window, q_offset,
                               softcap, stream);
}
