// K7: chunked RWKV6 wkv forward from a carried state (the zero state unless
// one is given).
//
// Replaces the TPU kernel repro/kernels/wkv/kernel.py::_kernel (entry point
// wkv_fwd, pallas_call at kernel.py:95).  Same function, per (batch, head):
// with the state S (hk x hv) starting at s0 (zero when none is given, as in
// the TPU kernel) and the sequence cut into
// chunks of C steps, each chunk computes, with la the cumulative log decay
// over the chunk and la_prev = la - logw,
//   o_t  = (r_t * exp(la_prev_t)) S                                (history)
//        + sum_{s<t} [sum_i r_t[i] k_s[i] exp(min(la_prev_t[i] - la_s[i], 0))] v_s
//        + (r_t . (u * k_t)) v_t                                   (bonus)
//   S   <- diag(exp(la_end)) S + sum_s diag(exp(la_end - la_s)) k_s v_s^T
// and returns (o, S_final), both f32.  Every exponent is a log-decay
// difference with t >= s, so it is <= 0 and safe in f32.
//
// What bounds it on an H100: at the RWKV6-7B prefill shapes (B=1, H=64,
// hk=hv=64, C <= 64) a call moves 16 S H h bytes (bf16 r/k/v, f32 logw and
// o) and does ~S C hk (exp + 2 FMA) for the pair term plus ~4 S hk hv FMAs,
// so bytes and operations are both small: the chunk walk is serial and one
// CTA per (batch, head) gives only 64 CTAs on 132 SMs, so latency bounds it.
//
// Numerics: f32 throughout, as in the TPU kernel: the cumulative log decay,
// the exponentials, the state between chunks, the outputs and every sum.
// The sums run in a fixed sequential order, so they round differently from
// the plain version's (kernels/wkv/ref.py, PyTorch's reductions): at hk = 64
// an f32 sum of ~64 terms of size ~1 carries ~1e-5 of rounding whatever its
// order.  chip_smoke.py holds the two apart by a bound that scales with the
// sum of the terms' magnitudes, not by a fixed atol.
//
// Design, simple first, the TPU kernel's arithmetic in the same order:
// * one CTA of 256 threads per (batch, head) walks the chunks in order; the
//   state stays in shared memory for the whole sequence (16 KB);
// * per chunk, r/k/logw/v are staged as f32 in shared memory (row stride
//   65, so the pair term's column reads fall in distinct banks); one thread
//   per channel scans the log decay; the strictly lower pair matrix (C x C),
//   the bonus diagonal, the decayed r and k are formed in shared memory;
//   each thread then owns outputs (t, j) and state entries (i, j) with j
//   across the lanes;
// * the incoming state is zero for a prefill, or s0 (B, H, hk, hv) f32 for
//   a multi-token step that carries state in (a chunked prefill): it is
//   loaded into the shared state before the first chunk, and nothing else
//   changes.
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>

namespace {

constexpr int kMax = 64;       // largest chunk, hk and hv
constexpr int kLD = kMax + 1;  // row stride of the shared tiles
constexpr int kThreads = 256;
// pair matrix, r, k, la, la_prev, v and state tiles; bonus diagonal and u
constexpr size_t kSmemBytes = sizeof(float) * (7 * kMax * kLD + 2 * kMax);

__device__ __forceinline__ float to_f32(float v) { return v; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 v) { return __bfloat162float(v); }

template <typename T>
__global__ void __launch_bounds__(kThreads)
wkv_fwd_kernel(const T* __restrict__ r, const T* __restrict__ k, const T* __restrict__ v,
               const float* __restrict__ logw, const float* __restrict__ u,
               const float* __restrict__ s0, float* __restrict__ o, float* __restrict__ s_out,
               int S, int H, int hk, int hv, int chunk) {
  extern __shared__ float smem[];
  float* A = smem;              // [C][kLD] pair term, s < t
  float* dg = A + kMax * kLD;   // [C] bonus diagonal
  float* rs = dg + kMax;        // [C][kLD] r, then r * exp(la_prev)
  float* ks = rs + kMax * kLD;  // [C][kLD] k, then k * exp(la_end - la)
  float* la = ks + kMax * kLD;  // [C][kLD] cumulative log decay
  float* lp = la + kMax * kLD;  // [C][kLD] logw, then la_prev
  float* vs = lp + kMax * kLD;  // [C][kLD] v
  float* St = vs + kMax * kLD;  // [hk][kLD] state
  float* us = St + kMax * kLD;  // [hk] bonus

  const int b = blockIdx.x / H, h = blockIdx.x % H;
  const int tid = threadIdx.x;
  const long long rk_row = static_cast<long long>(H) * hk;  // (B, S, H, d) rows
  const long long v_row = static_cast<long long>(H) * hv;
  const long long rk0 = static_cast<long long>(b) * S * rk_row + static_cast<long long>(h) * hk;
  const long long v0 = static_cast<long long>(b) * S * v_row + static_cast<long long>(h) * hv;

  const float* si = s0 ? s0 + static_cast<long long>(blockIdx.x) * hk * hv : nullptr;
  for (int e = tid; e < hk * hv; e += kThreads) St[(e / hv) * kLD + e % hv] = si ? si[e] : 0.0f;
  for (int i = tid; i < hk; i += kThreads) us[i] = u[h * hk + i];

  for (int c0 = 0; c0 < S; c0 += chunk) {
    __syncthreads();  // the previous chunk is done with every tile
    for (int e = tid; e < chunk * hk; e += kThreads) {
      const int t = e / hk, i = e % hk;
      const long long g = rk0 + (c0 + t) * rk_row + i;
      rs[t * kLD + i] = to_f32(r[g]);
      ks[t * kLD + i] = to_f32(k[g]);
      lp[t * kLD + i] = logw[g];
    }
    for (int e = tid; e < chunk * hv; e += kThreads) {
      const int t = e / hv, j = e % hv;
      vs[t * kLD + j] = to_f32(v[v0 + (c0 + t) * v_row + j]);
    }
    __syncthreads();

    // cumulative log decay per channel: la = cumsum(w), la_prev = la - w
    for (int i = tid; i < hk; i += kThreads) {
      float run = 0.0f;
      for (int t = 0; t < chunk; ++t) {
        const float w = lp[t * kLD + i];
        run += w;
        la[t * kLD + i] = run;
        lp[t * kLD + i] = run - w;
      }
    }
    __syncthreads();

    // strictly lower pair term and the bonus diagonal
    for (int e = tid; e < chunk * chunk; e += kThreads) {
      const int t = e / chunk, s = e % chunk;
      if (s >= t) continue;
      const float* rt = rs + t * kLD;
      const float* lt = lp + t * kLD;
      const float* kss = ks + s * kLD;
      const float* ls = la + s * kLD;
      float a = 0.0f;
      for (int i = 0; i < hk; ++i) a = fmaf(rt[i] * kss[i], expf(fminf(lt[i] - ls[i], 0.0f)), a);
      A[t * kLD + s] = a;
    }
    for (int t = tid; t < chunk; t += kThreads) {
      float d = 0.0f;
      for (int i = 0; i < hk; ++i) d = fmaf(rs[t * kLD + i] * us[i], ks[t * kLD + i], d);
      dg[t] = d;
    }
    __syncthreads();

    // decayed r for the history read, decayed k for the state update
    const float* la_end = la + (chunk - 1) * kLD;
    for (int e = tid; e < chunk * hk; e += kThreads) {
      const int t = e / hk, i = e % hk;
      rs[t * kLD + i] *= expf(lp[t * kLD + i]);
      ks[t * kLD + i] *= expf(la_end[i] - la[t * kLD + i]);
    }
    __syncthreads();

    // outputs, against the incoming state
    for (int e = tid; e < chunk * hv; e += kThreads) {
      const int t = e / hv, j = e % hv;
      float hist = 0.0f;
      for (int i = 0; i < hk; ++i) hist = fmaf(rs[t * kLD + i], St[i * kLD + j], hist);
      float pv = 0.0f;
      for (int s = 0; s < t; ++s) pv = fmaf(A[t * kLD + s], vs[s * kLD + j], pv);
      o[v0 + (c0 + t) * v_row + j] = (hist + pv) + dg[t] * vs[t * kLD + j];
    }
    __syncthreads();  // every read of the incoming state is done

    // state update
    for (int e = tid; e < hk * hv; e += kThreads) {
      const int i = e / hv, j = e % hv;
      float kv = 0.0f;
      for (int s = 0; s < chunk; ++s) kv = fmaf(ks[s * kLD + i], vs[s * kLD + j], kv);
      St[i * kLD + j] = fmaf(St[i * kLD + j], expf(la_end[i]), kv);
    }
  }
  __syncthreads();
  float* so = s_out + static_cast<long long>(blockIdx.x) * hk * hv;
  for (int e = tid; e < hk * hv; e += kThreads) so[e] = St[(e / hv) * kLD + e % hv];
}

template <typename T>
int launch(const void* r, const void* k, const void* v, const void* logw, const void* u,
           const void* s0, void* o, void* s_out, int B, int S, int H, int hk, int hv,
           int chunk, void* stream) {
  if (hk < 1 || hk > kMax || hv < 1 || hv > kMax || chunk < 1 || chunk > kMax ||
      S % chunk != 0)
    return static_cast<int>(cudaErrorInvalidValue);
  cudaError_t e = cudaFuncSetAttribute(wkv_fwd_kernel<T>,
                                       cudaFuncAttributeMaxDynamicSharedMemorySize,
                                       static_cast<int>(kSmemBytes));
  if (e != cudaSuccess) return static_cast<int>(e);
  wkv_fwd_kernel<T><<<B * H, kThreads, kSmemBytes, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const T*>(r), static_cast<const T*>(k), static_cast<const T*>(v),
      static_cast<const float*>(logw), static_cast<const float*>(u),
      static_cast<const float*>(s0), static_cast<float*>(o), static_cast<float*>(s_out), S, H,
      hk, hv, chunk);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// s0: (B, H, hk, hv) f32 incoming state, or null for the zero state.
extern "C" int wkv_fwd_f32(const void* r, const void* k, const void* v, const void* logw,
                           const void* u, const void* s0, void* o, void* s_out, int B, int S,
                           int H, int hk, int hv, int chunk, void* stream) {
  return launch<float>(r, k, v, logw, u, s0, o, s_out, B, S, H, hk, hv, chunk, stream);
}

extern "C" int wkv_fwd_bf16(const void* r, const void* k, const void* v, const void* logw,
                            const void* u, const void* s0, void* o, void* s_out, int B, int S,
                            int H, int hk, int hv, int chunk, void* stream) {
  return launch<__nv_bfloat16>(r, k, v, logw, u, s0, o, s_out, B, S, H, hk, hv, chunk,
                               stream);
}
