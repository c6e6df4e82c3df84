// K5: flash-attention forward, GQA, causal / sliding-window / tanh softcap.
//
// Replaces the TPU kernel repro/kernels/flash/kernel.py::_kernel (entry point
// flash_attention_fwd, pallas_call at kernel.py:112).  Same function: for
// each query row, softmax over the keys it may see (causal: key <= query;
// window w > 0: key > query - w) of scale * q.k, optionally tanh-softcapped,
// times V; the online softmax keeps a running (max m, sum l, acc) in f32 and
// the (S x T) score matrix never reaches device memory.  A row with no
// visible key writes zeros (kernel.py:72-75).
//
// What bounds it on an H100: at the Llama-3.2-1B prefill shapes (B=1,
// S <= 1,024, H=32, K=8, h=64, bf16) a call reads q/k/v once (~5 MB at
// S=1,000) and does ~2 S^2/2 H h multiply-adds, so the operations bound it
// (about 4 µs of bf16 tensor-core time against 1.5 µs of bytes at S=1,000).
// This first kernel runs its products in f32 on the CUDA cores, not on the
// tensor cores: it is right and simple first; wgmma, TMA and warp
// specialisation are later work.
//
// Design:
// * one CTA of 128 threads per (batch*query head, block of 64 query rows),
//   the heaviest causal blocks launched first; two threads per query row;
// * GQA without a copy: query head hq reads KV head hq / G in place;
// * inputs are (B, S, n, h) with any batch, row and head strides and a
//   contiguous head dim, so views of a projection are read as they are;
//   bf16 or f32 in, converted to f32 as the tiles are staged;
// * Q, K and V tiles live in shared memory as f32 (row stride h+4: 16-byte
//   float4 reads, banks staggered); each thread holds the scores of half the
//   keys of a block and half of its row's accumulator in registers; the
//   probabilities pass through shared memory between the two products;
// * key blocks wholly above the diagonal or before the window are skipped,
//   and the ragged tails of S and T are bounds-checked (zero tiles, masked
//   scores), so any S works.
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>

namespace {

constexpr int kBQ = 64;        // query rows per CTA
constexpr int kThreads = 128;  // two threads per query row

__device__ __forceinline__ float to_f32(float v) { return v; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 v) { return __bfloat162float(v); }

template <typename T> __device__ __forceinline__ T from_f32(float v);
template <> __device__ __forceinline__ float from_f32<float>(float v) { return v; }
template <> __device__ __forceinline__ __nv_bfloat16 from_f32<__nv_bfloat16>(float v) {
  return __float2bfloat16_rn(v);
}

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
                 int T_, int H, int G, float scale, int causal, int window, float softcap) {
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

  int kend = T_;
  if (causal) kend = min(T_, q0 + kBQ);  // no key after the block's last row
  int kbeg = window ? max(0, q0 - window + 1) : 0;
  kbeg = (kbeg / BK) * BK;

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
      const bool ok = kj < T_ && (!causal || kj <= qi) && (window == 0 || kj > qi - window);
      sc[c] = ok ? s : -INFINITY;
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

template <typename T, int HD>
int launch_hd(const void* q, const void* k, const void* v, void* o, int B, int S, int T_,
              int H, int K, Strides qs, Strides ks, Strides vs, Strides os, float scale,
              int causal, int window, float softcap, void* stream) {
  const size_t smem = smem_bytes<HD>();
  cudaError_t e = cudaFuncSetAttribute(flash_fwd_kernel<T, HD>,
                                       cudaFuncAttributeMaxDynamicSharedMemorySize,
                                       static_cast<int>(smem));
  if (e != cudaSuccess) return static_cast<int>(e);
  const dim3 grid((S + kBQ - 1) / kBQ, B * H);
  flash_fwd_kernel<T, HD><<<grid, kThreads, smem, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const T*>(q), static_cast<const T*>(k), static_cast<const T*>(v),
      static_cast<T*>(o), qs, ks, vs, os, S, T_, H, H / K, scale, causal, window, softcap);
  return static_cast<int>(cudaGetLastError());
}

template <typename T>
int launch(const void* q, const void* k, const void* v, void* o, int B, int S, int T_, int H,
           int K, int hd, long long qsb, long long qss, long long qsn, long long ksb,
           long long kss, long long ksn, long long vsb, long long vss, long long vsn,
           long long osb, long long oss, long long osn, float scale, int causal, int window,
           float softcap, void* stream) {
  const Strides qs{qsb, qss, qsn}, ks{ksb, kss, ksn}, vs{vsb, vss, vsn}, os{osb, oss, osn};
  switch (hd) {
    case 64:
      return launch_hd<T, 64>(q, k, v, o, B, S, T_, H, K, qs, ks, vs, os, scale, causal,
                              window, softcap, stream);
    case 128:
      return launch_hd<T, 128>(q, k, v, o, B, S, T_, H, K, qs, ks, vs, os, scale, causal,
                               window, softcap, stream);
    case 256:
      return launch_hd<T, 256>(q, k, v, o, B, S, T_, H, K, qs, ks, vs, os, scale, causal,
                               window, softcap, stream);
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
                             int window, float softcap, void* stream) {
  return launch<float>(q, k, v, o, B, S, T_, H, K, hd, qsb, qss, qsn, ksb, kss, ksn, vsb,
                       vss, vsn, osb, oss, osn, scale, causal, window, softcap, stream);
}

extern "C" int flash_fwd_bf16(const void* q, const void* k, const void* v, void* o, int B,
                              int S, int T_, int H, int K, int hd, long long qsb, long long qss,
                              long long qsn, long long ksb, long long kss, long long ksn,
                              long long vsb, long long vss, long long vsn, long long osb,
                              long long oss, long long osn, float scale, int causal,
                              int window, float softcap, void* stream) {
  return launch<__nv_bfloat16>(q, k, v, o, B, S, T_, H, K, hd, qsb, qss, qsn, ksb, kss, ksn,
                               vsb, vss, vsn, osb, oss, osn, scale, causal, window, softcap,
                               stream);
}
