// K7: chunked RWKV6 wkv forward from a carried state (the zero state unless
// one is given).
//
// Replaces the TPU kernel repro/kernels/wkv/kernel.py::_kernel (entry point
// wkv_fwd, pallas_call at kernel.py:95).  Same function, per (batch, head):
// with the state S (hk x hv) starting at s0 (zero when none is given, as in
// the TPU kernel) and the sequence cut into tiles of T steps, each tile
// computes, with la the cumulative log decay over the tile and
// la_prev = la - logw,
//   o_t  = (r_t * exp(la_prev_t)) S                                (history)
//        + sum_{s<t} [sum_i r_t[i] k_s[i] exp(min(la_prev_t[i] - la_s[i], 0))] v_s
//        + (r_t . (u * k_t)) v_t                                   (bonus)
//   S   <- diag(exp(la_end)) S + sum_s diag(exp(la_end - la_s)) k_s v_s^T
// and returns (o, S_final), both f32.  Every exponent is a log-decay
// difference with t >= s, so it is <= 0 and safe in f32.  The result does
// not depend on T (the TPU kernel's chunk exists because Pallas needs equal
// blocks): T is this kernel's own tile, kTile = 32 whatever the chunk, and
// the last tile may be ragged, so a prime S no longer runs as S tiles of
// one step.
//
// What bounds it on an H100: at the RWKV6-7B prefill shapes (B=1, H=64,
// hk=hv=64) a call moves 16 S H h bytes (bf16 r/k/v, f32 logw and o) and
// does ~2 S hk hv f32 FMAs for the history read and the state update plus
// ~S T hk / 2 exp + FMA for the pair term (T the tile): the least of that
// work over tiles is at T ~ 7, at S 1,000 about 18 us at the CUDA cores'
// f32 peak against 17 us of bytes (chip_smoke.py::k7_bound).  Only the
// state carry is sequential; what bounds the kernel is its latency.
//
// Design, two kernels on one stream:
// * wkv_intra_kernel, grid (B*H, tiles): each CTA computes one tile's
//   intra-tile output (the pair term times v plus the bonus), which depends
//   on r, k, v and logw alone, and writes it to o; the pair term in 2 x 2
//   blocks of (t, s) pairs, a block's channels split over two lanes, and
//   the pair term times v in 2-row x 4-column blocks.  It also writes what
//   the carry needs, to scratch the wrapper allocates:
//   r * exp(la_prev), k * exp(la_end - la) and exp(la_end).  At S 1,000 and
//   T 32 that is 2,048 CTAs in parallel, where the first design walked 64
//   CTAs through the chunks in order.
// * wkv_carry_kernel, grid (B*H, hv / 16): each CTA owns a 16-column slice
//   of the state (neither the history read nor the update mixes columns),
//   held in registers, and walks the tiles in order: two warps update the
//   slice while four add the history read to o, each thread on a 4 x 4
//   block (these loops are bound by shared-memory reads, and a block makes
//   one read feed four multiply-adds), while cp.async brings the next
//   two tiles' inputs.  256 CTAs at B 1, two to an SM.
// The cumulative log decay is a two-level scan (4 segments of the tile per
// channel, then their offsets), in base 2 so every exponential is an exp2f.
//
// Numerics: f32 throughout, as in the TPU kernel: the cumulative log decay,
// the exponentials, the state between tiles, the outputs and every sum.
// The sums run in a fixed order, so they round differently from the plain
// version's (kernels/wkv/ref.py, PyTorch's reductions): at hk = 64 an f32
// sum of ~64 terms of size ~1 carries ~1e-5 of rounding whatever its order,
// and each exponent, a difference of cumulative sums over a tile, carries
// the rounding of those sums (larger for a longer tile).  chip_smoke.py
// holds the two apart by a bound that scales with the sum of the terms'
// magnitudes, not by a fixed atol.  kernels/wkv/ref.py::wkv_two_pass models
// this order (tiles, ragged last tile, hv slices) on the CPU.
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace {

constexpr int kMax = 64;       // largest hk and hv
constexpr int kTile = 32;      // the tile of S (kernels/wkv/kernel.py::TILE)
constexpr int kStages = 3;     // the carry's sets of input buffers: two tiles in flight
constexpr int kLD = kMax + 1;  // row stride of the shared tiles
constexpr int kThreads = 256;
constexpr int kSeg = kThreads / kMax;  // segments of the decay scan
constexpr int kJT = 16;        // state columns a carry CTA owns
constexpr float kLog2e = 1.4426950408889634f;  // the decays are kept in base 2
constexpr int kLA = kMax + 4;  // row stride of the carry's r_dec / k_dec tiles (16-byte rows)
constexpr int kSTR = 24;       // row stride of the carry's state mirror: 4 rows, distinct banks

// f32 words of one of the carry's sets of input buffers (see
// wkv_carry_kernel), a multiple of 4 so each part stays 16-byte aligned.
template <typename T>
__host__ __device__ constexpr int carry_buf_words() {
  return 2 * kTile * kLA + kTile * kJT + kMax +
         (kTile * kJT * static_cast<int>(sizeof(T)) + 15) / 16 * 4;
}

__device__ __forceinline__ float to_f32(float v) { return v; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 v) { return __bfloat162float(v); }

// Cumulative log decay per channel over the tile's L rows, in base 2 (every
// exponential is an exp2f, which issues fewer instructions than expf): on
// entry lp holds logw * log2(e); on exit la = cumsum(lp) and lp = la - lp.
// Each of kSeg segments of rows is scanned by its own thread per channel,
// then shifted by the segments before it.  Ends with a barrier.
__device__ __forceinline__ void decay_scan(float* la, float* lp, float* part, int L, int hk) {
  const int i = threadIdx.x % kMax, g = threadIdx.x / kMax;
  const int per = (L + kSeg - 1) / kSeg;
  const int t0 = g * per, t1 = min(L, t0 + per);
  float run = 0.0f;
  if (i < hk)
    for (int t = t0; t < t1; ++t) {
      run += lp[t * kLD + i];
      la[t * kLD + i] = run;
    }
  part[g * kMax + i] = run;
  __syncthreads();
  float off = 0.0f;
  for (int q = 0; q < g; ++q) off += part[q * kMax + i];
  if (i < hk)
    for (int t = t0; t < t1; ++t) {
      const float a = la[t * kLD + i] + off;
      la[t * kLD + i] = a;
      lp[t * kLD + i] = a - lp[t * kLD + i];
    }
  __syncthreads();
}

// One tile's intra-tile output: o = (pair * v) + bonus * v.
template <typename T, int HK>
__global__ void __launch_bounds__(kThreads)
wkv_intra_kernel(const T* __restrict__ r, const T* __restrict__ k, const T* __restrict__ v,
                 const float* __restrict__ logw, const float* __restrict__ u,
                 float* __restrict__ o, float* __restrict__ rdec, float* __restrict__ kdec,
                 float* __restrict__ dend, int S, int H, int hk_, int hv) {
  constexpr int tile = kTile;
  const int hk = HK ? HK : hk_;  // a compile-time head size unrolls the channel loops
  extern __shared__ float4 smem4i[];
  float* vs = reinterpret_cast<float*>(smem4i);  // [T][kLA] v, 16-byte rows, zero past hv
  float* rs = vs + tile * kLA;  // [T][kLD] r
  float* ks = rs + tile * kLD;  // [T][kLD] k
  float* la = ks + tile * kLD;  // [T][kLD] cumulative log decay
  float* lp = la + tile * kLD;  // [T][kLD] logw, then la_prev
  float* A = lp + tile * kLD;   // [T][T + 1] pair term, s < t
  float* dg = A + tile * (tile + 1);  // [T] bonus diagonal
  float* us = dg + tile;        // [hk] bonus
  float* part = us + kMax;      // [kSeg][kMax] decay scan segments

  const int b = blockIdx.x / H, h = blockIdx.x % H;
  const int c0 = blockIdx.y * tile, L = min(tile, S - c0);
  const int tid = threadIdx.x;
  const long long rk_row = static_cast<long long>(H) * hk;  // (B, S, H, d) rows
  const long long v_row = static_cast<long long>(H) * hv;
  const long long rk0 = (static_cast<long long>(b) * S + c0) * rk_row +
                        static_cast<long long>(h) * hk;
  const long long v0 = (static_cast<long long>(b) * S + c0) * v_row +
                       static_cast<long long>(h) * hv;

  for (int e = tid; e < L * hk; e += kThreads) {
    const int t = e / hk, i = e % hk;
    const long long g = rk0 + t * rk_row + i;
    rs[t * kLD + i] = to_f32(r[g]);
    ks[t * kLD + i] = to_f32(k[g]);
    lp[t * kLD + i] = logw[g] * kLog2e;
  }
  const int hv4 = (hv + 3) / 4;  // quads of v's columns
  for (int e = tid; e < L * 4 * hv4; e += kThreads) {
    const int t = e / (4 * hv4), j = e % (4 * hv4);
    vs[t * kLA + j] = j < hv ? to_f32(v[v0 + t * v_row + j]) : 0.0f;
  }
  for (int i = tid; i < hk; i += kThreads) us[i] = u[h * hk + i];
  __syncthreads();
  decay_scan(la, lp, part, L, hk);

  // strictly lower pair term in 2 x 2 blocks of (t, s) pairs, each block's
  // channels split between two neighbouring lanes (even and odd channels):
  // a lane reads two rows of r, la_prev, k and la for four pairs
  const int nb = (L + 1) / 2;            // blocks of two rows
  const int blocks = nb * (nb + 1) / 2;  // blocks on or below the diagonal
  for (int base = 0; base < 2 * blocks; base += kThreads) {
    const int e = base + tid, blk = e / 2, half = e % 2;
    float a00 = 0.0f, a01 = 0.0f, a10 = 0.0f, a11 = 0.0f;  // (t0|t1, s0|s1)
    int t0 = 0, s0 = 0;
    if (blk < blocks) {
      int bt = static_cast<int>((sqrtf(8.0f * blk + 1.0f) - 1.0f) * 0.5f);
      while (bt * (bt + 1) / 2 > blk) --bt;
      while ((bt + 1) * (bt + 2) / 2 <= blk) ++bt;
      t0 = 2 * bt;
      s0 = 2 * (blk - bt * (bt + 1) / 2);
      const int t1 = min(t0 + 1, L - 1), s1 = min(s0 + 1, L - 1);  // masked below
      const float *r0 = rs + t0 * kLD, *r1 = rs + t1 * kLD;
      const float *p0 = lp + t0 * kLD, *p1 = lp + t1 * kLD;
      const float *k0 = ks + s0 * kLD, *k1 = ks + s1 * kLD;
      const float *q0 = la + s0 * kLD, *q1 = la + s1 * kLD;
      for (int i = half; i < hk; i += 2) {
        const float x0 = r0[i], x1 = r1[i], y0 = k0[i], y1 = k1[i];
        const float u0 = p0[i], u1 = p1[i], w0 = q0[i], w1 = q1[i];
        a00 = fmaf(x0 * y0, exp2f(fminf(u0 - w0, 0.0f)), a00);
        a01 = fmaf(x0 * y1, exp2f(fminf(u0 - w1, 0.0f)), a01);
        a10 = fmaf(x1 * y0, exp2f(fminf(u1 - w0, 0.0f)), a10);
        a11 = fmaf(x1 * y1, exp2f(fminf(u1 - w1, 0.0f)), a11);
      }
    }
    a00 += __shfl_xor_sync(0xffffffffu, a00, 1);
    a01 += __shfl_xor_sync(0xffffffffu, a01, 1);
    a10 += __shfl_xor_sync(0xffffffffu, a10, 1);
    a11 += __shfl_xor_sync(0xffffffffu, a11, 1);
    if (blk < blocks && half == 0) {
      const int t1 = t0 + 1, s1 = s0 + 1;
      if (s0 < t0) A[t0 * (tile + 1) + s0] = a00;
      if (s1 < t0) A[t0 * (tile + 1) + s1] = a01;
      if (t1 < L && s0 < t1) A[t1 * (tile + 1) + s0] = a10;
      if (t1 < L && s1 < t1) A[t1 * (tile + 1) + s1] = a11;
    }
  }
  for (int t = tid; t < L; t += kThreads) {
    float d = 0.0f;
    for (int i = 0; i < hk; ++i) d = fmaf(rs[t * kLD + i] * us[i], ks[t * kLD + i], d);
    dg[t] = d;
  }
  __syncthreads();

  // o = pair * v + bonus * v, thread (rows t0 and t0 + 1, four columns): a
  // shared-memory read of v feeds eight multiply-adds
  for (int e = tid; e < (L + 1) / 2 * hv4; e += kThreads) {
    const int jq = e % hv4, t0 = 2 * (e / hv4), t1 = t0 + 1;
    const float* a0 = A + t0 * (tile + 1);
    const float* a1 = A + min(t1, L - 1) * (tile + 1);
    float p0[4] = {}, p1[4] = {};
    for (int s = 0; s < t0; ++s) {
      const float4 vv = *reinterpret_cast<const float4*>(vs + s * kLA + 4 * jq);
      const float x0 = a0[s], x1 = a1[s];
      p0[0] = fmaf(x0, vv.x, p0[0]);
      p0[1] = fmaf(x0, vv.y, p0[1]);
      p0[2] = fmaf(x0, vv.z, p0[2]);
      p0[3] = fmaf(x0, vv.w, p0[3]);
      p1[0] = fmaf(x1, vv.x, p1[0]);
      p1[1] = fmaf(x1, vv.y, p1[1]);
      p1[2] = fmaf(x1, vv.z, p1[2]);
      p1[3] = fmaf(x1, vv.w, p1[3]);
    }
    const float4 w0 = *reinterpret_cast<const float4*>(vs + t0 * kLA + 4 * jq);
    const float v0c[4] = {w0.x, w0.y, w0.z, w0.w};
    float* o0 = o + v0 + t0 * v_row + 4 * jq;
#pragma unroll
    for (int c = 0; c < 4; ++c)
      if (4 * jq + c < hv) o0[c] = fmaf(dg[t0], v0c[c], p0[c]);
    if (t1 < L) {
      const float x1 = a1[t0];  // s = t0 is below the diagonal for row t1 only
      const float4 w1 = *reinterpret_cast<const float4*>(vs + t1 * kLA + 4 * jq);
      const float v1c[4] = {w1.x, w1.y, w1.z, w1.w};
      float* o1 = o0 + v_row;
#pragma unroll
      for (int c = 0; c < 4; ++c)
        if (4 * jq + c < hv) o1[c] = fmaf(dg[t1], v1c[c], fmaf(x1, v0c[c], p1[c]));
    }
  }

  // for the carry: r * exp(la_prev), k * exp(la_end - la) and exp(la_end),
  // rows of hk4 floats per (batch, head), step
  const int hk4 = (hk + 3) / 4 * 4;
  const long long d0 = (static_cast<long long>(blockIdx.x) * S + c0) * hk4;
  const float* la_end = la + (L - 1) * kLD;
  for (int e = tid; e < L * hk; e += kThreads) {
    const int t = e / hk, i = e % hk;
    rdec[d0 + t * hk4 + i] = rs[t * kLD + i] * exp2f(lp[t * kLD + i]);
    kdec[d0 + t * hk4 + i] = ks[t * kLD + i] * exp2f(la_end[i] - la[t * kLD + i]);
  }
  for (int i = tid; i < hk; i += kThreads)
    dend[(static_cast<long long>(blockIdx.x) * gridDim.y + blockIdx.y) * hk4 + i] =
        exp2f(la_end[i]);
}

__device__ __forceinline__ void cp_async16(void* dst, const void* src) {
  const unsigned d = static_cast<unsigned>(__cvta_generic_to_shared(dst));
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(d), "l"(src));
}
__device__ __forceinline__ void cp_async_commit() { asm volatile("cp.async.commit_group;\n"); }
template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N) : "memory");
}

// Four consecutive staged values as f32.
__device__ __forceinline__ float4 load4(const float* p) {
  return *reinterpret_cast<const float4*>(p);
}
__device__ __forceinline__ float4 load4(const __nv_bfloat16* p) {
  const uint2 u = *reinterpret_cast<const uint2*>(p);
  const float2 a = __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(&u.x));
  const float2 b = __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(&u.y));
  return make_float4(a.x, a.y, b.x, b.y);
}

// The state carry for one 16-column slice of the state: per tile, in order,
// o += r_dec S and S <- diag(exp(la_end)) S + k_dec^T v, from the intra
// pass's r_dec, k_dec and exp(la_end).  The next two tiles' inputs are
// copied into two more sets of buffers (cp.async) while this one computes.  Thread
// (i, q) keeps state row i, columns 4q..4q+3 of the slice in registers for
// the whole sequence and mirrors them in shared memory for the history
// read.
template <typename T, int HK>
__global__ void __launch_bounds__(kThreads, 2)  // two CTAs an SM: 256 at B 1 in one wave
wkv_carry_kernel(const float* __restrict__ rdec, const float* __restrict__ kdec,
                 const float* __restrict__ dend, const T* __restrict__ v,
                 const float* __restrict__ s0, float* __restrict__ o,
                 float* __restrict__ s_out, int S, int H, int hk_, int hv, int vec) {
  constexpr int tile = kTile, stages = kStages;
  const int hk = HK ? HK : hk_;
  extern __shared__ float4 smem4c[];
  const int hk4 = (hk + 3) / 4 * 4;
  constexpr int buf = carry_buf_words<T>();
  float* St = reinterpret_cast<float*>(smem4c);  // [hk][kSTR] state slice
  float* vf = St + kMax * kSTR;  // [T][kJT] v slice as f32
  float* bufs = vf + tile * kJT;

  const int bh = blockIdx.x, b = bh / H, h = bh % H;
  const int j0 = blockIdx.y * kJT, jw = min(kJT, hv - j0);
  const int tid = threadIdx.x;
  const long long v_row = static_cast<long long>(H) * hv;
  const long long v0 = static_cast<long long>(b) * S * v_row + static_cast<long long>(h) * hv + j0;
  const int ntiles = (S + tile - 1) / tile;

  // buffer n % stages: r_dec [T][kLA], k_dec [T][kLA], o slice [T][kJT]
  // f32, exp(la_end) [kMax], v slice [T][kJT] in T
  auto rd_of = [&](int n) { return bufs + (n % stages) * buf; };
  auto kd_of = [&](int n) { return rd_of(n) + tile * kLA; };
  auto ob_of = [&](int n) { return kd_of(n) + tile * kLA; };
  auto de_of = [&](int n) { return ob_of(n) + tile * kJT; };
  auto vb_of = [&](int n) { return reinterpret_cast<T*>(de_of(n) + kMax); };

  auto stage = [&](int n) {
    const int c0 = n * tile, L = min(tile, S - c0);
    const float* rg = rdec + (static_cast<long long>(bh) * S + c0) * hk4;
    const float* kg = kdec + (static_cast<long long>(bh) * S + c0) * hk4;
    const float* dg = dend + (static_cast<long long>(bh) * ntiles + n) * hk4;
    float* rd = rd_of(n);
    float* kd = kd_of(n);
    float* ob = ob_of(n);
    float* de = de_of(n);
    T* vb = vb_of(n);
    // 16-byte pieces, 16 slots a row of r_dec / k_dec (hk4 / 4 used) and 8
    // a row of v and o (those of v first), so a thread finds its piece by
    // shifts
    const int rq = hk4 / 4;
    for (int e = tid; e < L * 16; e += kThreads) {
      const int t = e >> 4, c = e & 15;
      if (c < rq) {
        cp_async16(rd + t * kLA + 4 * c, rg + t * hk4 + 4 * c);
        cp_async16(kd + t * kLA + 4 * c, kg + t * hk4 + 4 * c);
      }
    }
    if (tid < rq) cp_async16(de + 4 * tid, dg + 4 * tid);
    if (vec) {  // whole 16-column rows of v and o, 16-byte aligned
      constexpr int vq = kJT * sizeof(T) / 16;  // pieces of a row of v
      for (int e = tid; e < L * 8; e += kThreads) {
        const int t = e >> 3, c = e & 7;
        if (c < vq)
          cp_async16(vb + t * kJT + c * (16 / sizeof(T)),
                     v + v0 + (c0 + t) * v_row + c * (16 / sizeof(T)));
        else if (c < vq + kJT / 4)
          cp_async16(ob + t * kJT + 4 * (c - vq), o + v0 + (c0 + t) * v_row + 4 * (c - vq));
      }
    } else {
      for (int e = tid; e < L * kJT; e += kThreads) {
        const int t = e / kJT, jj = e % kJT;
        const bool in = jj < jw;
        vb[e] = in ? v[v0 + (c0 + t) * v_row + jj] : T(0.0f);
        ob[e] = in ? o[v0 + (c0 + t) * v_row + jj] : 0.0f;
      }
    }
  };

  // Warps 0-1 update the state: thread (ib, q) keeps rows 4ib..4ib+3,
  // columns 4q..4q+3 of the slice in registers for the whole sequence and
  // mirrors them in shared memory for the history read.  Warps 4-7 read the
  // history: thread (block of 4 rows t and 4 columns, channel group g) sums
  // the channels i = g (mod 4), and the four groups meet by shuffles.  4 x 4
  // blocks: a shared-memory read feeds four multiply-adds, the rate that
  // bounds these loops.
  const bool updater = tid < 64, reader = tid >= 128;
  const int ib = (tid >> 2) & 15, q = tid & 3;
  float st[4][4] = {};
  const float* si = s0 ? s0 + static_cast<long long>(bh) * hk * hv : nullptr;
  if (updater && si)
#pragma unroll
    for (int r = 0; r < 4; ++r)
#pragma unroll
      for (int c = 0; c < 4; ++c)
        if (4 * ib + r < hk && 4 * q + c < jw) st[r][c] = si[(4 * ib + r) * hv + j0 + 4 * q + c];

  for (int n = 0; n + 1 < stages; ++n) {  // the first stages - 1 tiles in flight
    if (n < ntiles) stage(n);
    cp_async_commit();
  }
  for (int n = 0; n < ntiles; ++n) {
    const int c0 = n * tile, L = min(tile, S - c0);
    __syncthreads();  // every thread is done with tile n - 1 and its buffers
    if (updater)
#pragma unroll
      for (int r = 0; r < 4; ++r)
        *reinterpret_cast<float4*>(St + (4 * ib + r) * kSTR + 4 * q) =
            make_float4(st[r][0], st[r][1], st[r][2], st[r][3]);
    if (n + stages - 1 < ntiles) stage(n + stages - 1);
    cp_async_commit();
    cp_async_wait<stages - 1>();  // this thread's copies of tile n have landed
    __syncthreads();  // everyone's, and the incoming state
    const float* rd = rd_of(n);
    const float* kd = kd_of(n);
    const float* ob = ob_of(n);
    const float* de = de_of(n);
    const T* vb = vb_of(n);
    for (int e = tid; e < L * kJT; e += kThreads) vf[e] = to_f32(vb[e]);  // v once as f32
    __syncthreads();

    if (reader) {
      // history read against the incoming state, added to the intra-tile output
      const int hid = tid - 128, g = hid & 3, hq = (hid >> 2) & 3, tb = hid >> 4;
      for (int base = 0; base < L; base += 32) {  // the same trips in every lane
        const int t0 = base + 4 * tb;
        float h[4][4] = {};
        const float* r0 = rd + min(t0, L - 1) * kLA;
        const float* r1 = rd + min(t0 + 1, L - 1) * kLA;
        const float* r2 = rd + min(t0 + 2, L - 1) * kLA;
        const float* r3 = rd + min(t0 + 3, L - 1) * kLA;
#pragma unroll 4
        for (int i = g; i < hk; i += 4) {
          const float4 sv = *reinterpret_cast<const float4*>(St + i * kSTR + 4 * hq);
          const float a[4] = {r0[i], r1[i], r2[i], r3[i]};
#pragma unroll
          for (int r = 0; r < 4; ++r) {
            h[r][0] = fmaf(a[r], sv.x, h[r][0]);
            h[r][1] = fmaf(a[r], sv.y, h[r][1]);
            h[r][2] = fmaf(a[r], sv.z, h[r][2]);
            h[r][3] = fmaf(a[r], sv.w, h[r][3]);
          }
        }
#pragma unroll
        for (int r = 0; r < 4; ++r)
#pragma unroll
          for (int c = 0; c < 4; ++c) {
            h[r][c] += __shfl_xor_sync(0xffffffffu, h[r][c], 1);
            h[r][c] += __shfl_xor_sync(0xffffffffu, h[r][c], 2);
          }
        const int t = t0 + g;  // lane g of the group writes row t0 + g
        if (t < L) {
          const float4 base = *reinterpret_cast<const float4*>(ob + t * kJT + 4 * hq);
          float hs[4];
#pragma unroll
          for (int c = 0; c < 4; ++c)  // row g of the block, picked without local memory
            hs[c] = g == 0 ? h[0][c] : g == 1 ? h[1][c] : g == 2 ? h[2][c] : h[3][c];
          const float4 out = make_float4(base.x + hs[0], base.y + hs[1], base.z + hs[2],
                                         base.w + hs[3]);
          float* og = o + v0 + (c0 + t) * v_row + 4 * hq;
          if (vec) {
            *reinterpret_cast<float4*>(og) = out;
          } else {
            const float oc[4] = {out.x, out.y, out.z, out.w};
#pragma unroll
            for (int c = 0; c < 4; ++c)
              if (4 * hq + c < jw) og[c] = oc[c];
          }
        }
      }
    } else if (updater) {
      // state update, in registers: S <- diag(exp(la_end)) S + k_dec^T v
      float u[4][4] = {};
      const float4* v4 = reinterpret_cast<const float4*>(vf);
#pragma unroll 2
      for (int t = 0; t < L; ++t) {
        const float4 kv = *reinterpret_cast<const float4*>(kd + t * kLA + 4 * ib);
        const float4 vv = v4[t * (kJT / 4) + q];
        const float a[4] = {kv.x, kv.y, kv.z, kv.w};
#pragma unroll
        for (int r = 0; r < 4; ++r) {
          u[r][0] = fmaf(a[r], vv.x, u[r][0]);
          u[r][1] = fmaf(a[r], vv.y, u[r][1]);
          u[r][2] = fmaf(a[r], vv.z, u[r][2]);
          u[r][3] = fmaf(a[r], vv.w, u[r][3]);
        }
      }
      const float4 d4 = *reinterpret_cast<const float4*>(de + 4 * ib);
      const float d[4] = {d4.x, d4.y, d4.z, d4.w};
#pragma unroll
      for (int r = 0; r < 4; ++r)
#pragma unroll
        for (int c = 0; c < 4; ++c) st[r][c] = fmaf(st[r][c], d[r], u[r][c]);
    }
  }
  float* so = s_out + static_cast<long long>(bh) * hk * hv;
  if (updater)
#pragma unroll
    for (int r = 0; r < 4; ++r)
#pragma unroll
      for (int c = 0; c < 4; ++c)
        if (4 * ib + r < hk && 4 * q + c < jw) so[(4 * ib + r) * hv + j0 + 4 * q + c] = st[r][c];
}

constexpr size_t kIntraSmem =
    sizeof(float) * (kTile * kLA + 4 * kTile * kLD + kTile * (kTile + 1) + kTile + kMax +
                     kSeg * kMax);

template <typename T>
constexpr size_t carry_smem() {
  return sizeof(float) * (kMax * kSTR + kTile * kJT + kStages * carry_buf_words<T>());
}
static_assert(2 * carry_smem<float>() <= 227 * 1024, "two carry CTAs must fit an SM");

template <typename T, int HK>
int launch_hk(const void* r, const void* k, const void* v, const void* logw, const void* u,
           const void* s0, void* o, void* s_out, void* rdec, void* kdec, void* dend, int B,
           int S, int H, int hk, int hv, void* stream) {
  if (hk < 1 || hk > kMax || hv < 1 || hv > kMax || S < 1 || B < 1 || H < 1)
    return static_cast<int>(cudaErrorInvalidValue);
  const size_t si = kIntraSmem, sc = carry_smem<T>();
  cudaError_t e = cudaFuncSetAttribute(wkv_intra_kernel<T, HK>,
                                       cudaFuncAttributeMaxDynamicSharedMemorySize,
                                       static_cast<int>(si));
  if (e != cudaSuccess) return static_cast<int>(e);
  e = cudaFuncSetAttribute(wkv_carry_kernel<T, HK>, cudaFuncAttributeMaxDynamicSharedMemorySize,
                           static_cast<int>(sc));
  if (e != cudaSuccess) return static_cast<int>(e);
  // all of the SM's unified memory as shared memory, so two carry CTAs fit
  e = cudaFuncSetAttribute(wkv_carry_kernel<T, HK>, cudaFuncAttributePreferredSharedMemoryCarveout,
                           100);
  if (e != cudaSuccess) return static_cast<int>(e);
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  const T* vp = static_cast<const T*>(v);
  float* op = static_cast<float*>(o);
  float* rd = static_cast<float*>(rdec);
  float* kd = static_cast<float*>(kdec);
  float* dd = static_cast<float*>(dend);
  wkv_intra_kernel<T, HK><<<dim3(B * H, (S + kTile - 1) / kTile), kThreads, si, st>>>(
      static_cast<const T*>(r), static_cast<const T*>(k), vp, static_cast<const float*>(logw),
      static_cast<const float*>(u), op, rd, kd, dd, S, H, hk, hv);
  e = cudaGetLastError();
  if (e != cudaSuccess) return static_cast<int>(e);
  // v and o rows in whole 16-column, 16-byte aligned pieces: cp.async them
  const int vec = hv % kJT == 0 && reinterpret_cast<uintptr_t>(v) % 16 == 0 &&
                  reinterpret_cast<uintptr_t>(o) % 16 == 0;
  wkv_carry_kernel<T, HK><<<dim3(B * H, (hv + kJT - 1) / kJT), kThreads, sc, st>>>(
      rd, kd, dd, vp, static_cast<const float*>(s0), op, static_cast<float*>(s_out), S, H, hk,
      hv, vec);
  return static_cast<int>(cudaGetLastError());
}

// The RWKV6 head size, 64, with its channel loops unrolled; any other
// through the general kernels.
template <typename T>
int launch(const void* r, const void* k, const void* v, const void* logw, const void* u,
           const void* s0, void* o, void* s_out, void* rdec, void* kdec, void* dend, int B,
           int S, int H, int hk, int hv, void* stream) {
  return hk == kMax ? launch_hk<T, kMax>(r, k, v, logw, u, s0, o, s_out, rdec, kdec, dend, B,
                                         S, H, hk, hv, stream)
                    : launch_hk<T, 0>(r, k, v, logw, u, s0, o, s_out, rdec, kdec, dend, B, S,
                                      H, hk, hv, stream);
}

}  // namespace

// s0: (B, H, hk, hv) f32 incoming state, or null for the zero state; rdec
// and kdec: (B*H, S, hk4) f32 scratch, dend: (B*H, ceil(S / kTile), hk4) f32
// scratch, with hk4 = hk rounded up to a multiple of 4.
extern "C" int wkv_fwd_f32(const void* r, const void* k, const void* v, const void* logw,
                           const void* u, const void* s0, void* o, void* s_out, void* rdec,
                           void* kdec, void* dend, int B, int S, int H, int hk, int hv,
                           void* stream) {
  return launch<float>(r, k, v, logw, u, s0, o, s_out, rdec, kdec, dend, B, S, H, hk, hv,
                       stream);
}

extern "C" int wkv_fwd_bf16(const void* r, const void* k, const void* v, const void* logw,
                            const void* u, const void* s0, void* o, void* s_out, void* rdec,
                            void* kdec, void* dend, int B, int S, int H, int hk, int hv,
                            void* stream) {
  return launch<__nv_bfloat16>(r, k, v, logw, u, s0, o, s_out, rdec, kdec, dend, B, S, H, hk,
                               hv, stream);
}
