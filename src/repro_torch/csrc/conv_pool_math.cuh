// Shared arithmetic of the fused conv+act+pool kernels (conv_pool.cu,
// conv_pool_q8.cu, conv_pool_dw.cu, conv_pool_dw_q8.cu): output geometry,
// the window index math, padding as bounds-checked taps, the int8
// requantization, per tensor and per channel, and K1's and K2's tile (the
// input rows and conv positions a run of pooled rows needs, and its shared
// memory).
//
// Everything here is __host__ __device__ so that a plain C++ compiler can
// build the host side into a small library (conv_pool_math_host.cpp) and the
// CPU tests can hold it against the reference package's numerics; nvcc
// builds the same lines into the kernels.
#pragma once

#include <math.h>
#include <stdint.h>

#if defined(__CUDACC__)
#define CP_HD __host__ __device__ __forceinline__
#else
#define CP_HD inline
#endif

namespace cp {

// Conv output extent along one axis: floor((in + 2*pad - k) / stride) + 1.
CP_HD int conv_out(int in, int pad, int k, int stride) {
  return (in + 2 * pad - k) / stride + 1;
}

// Pooled extent along one axis (unpadded pool, as FusedConvPool requires).
CP_HD int pool_out(int in, int k, int stride) { return (in - k) / stride + 1; }

// Conv output position read by window offset `i` of pooled position `p`.
CP_HD int conv_pos(int p, int pool_stride, int i) { return p * pool_stride + i; }

// First input position (in unpadded coordinates; may be negative) read by
// conv output position `o`.  Tap `d` then reads `origin + d`.
CP_HD int in_origin(int o, int conv_stride, int pad) { return o * conv_stride - pad; }

// A tap outside [0, n) reads the zero padding: the kernels skip it.
CP_HD bool in_bounds(int i, int n) { return static_cast<unsigned>(i) < static_cast<unsigned>(n); }

// f32 product rounded to nearest even, never contracted into an FMA.
CP_HD float mul_rn(float a, float b) {
#if defined(__CUDA_ARCH__)
  return __fmul_rn(a, b);
#else
  return a * b;
#endif
}

// int32 -> f32, rounded to nearest even (what astype(float32) does).
CP_HD float i2f_rn(int32_t a) {
#if defined(__CUDA_ARCH__)
  return __int2float_rn(a);
#else
  return static_cast<float>(a);
#endif
}

// The reference's requantize (repro/core/quantize.py:198-207):
// f32(acc) * m, round half to even, saturate to [-128, 127].  rintf rounds
// half to even under the default rounding mode; roundf would round half
// away from zero and is never used here.
CP_HD int8_t requant(int32_t acc, float m) {
  float v = rintf(mul_rn(i2f_rn(acc), m));
  v = fminf(fmaxf(v, -128.0f), 127.0f);
  return static_cast<int8_t>(v);
}

// The reference's requantize_per_channel (repro/core/quantize.py:210):
// channel c of an (N, C, H, W) accumulator is requantized with m[c].  K4
// computes requant(acc, m[c]) with m[c] read once, before its input loads.
CP_HD int8_t requant_per_channel(int32_t acc, const float* m, int c) {
  return requant(acc, m[c]);
}

// Channel of element i of a contiguous (N, C, H, W) tensor with hw = H*W.
CP_HD int nchw_channel(long long i, int c, int hw) {
  return static_cast<int>((i / hw) % c);
}

// Geometry of one fused conv+act+pool call, NCHW.
struct Geom {
  int n, cin, h, w, cout, kh, kw, csh, csw, padh, padw, pkh, pkw, psh, psw;
  int oh, ow, ph, pw;
};

CP_HD Geom make_geom(int n, int cin, int h, int w, int cout, int kh, int kw,
                     int csh, int csw, int padh, int padw, int pkh, int pkw,
                     int psh, int psw) {
  Geom g{n, cin, h, w, cout, kh, kw, csh, csw, padh, padw, pkh, pkw, psh, psw,
         0, 0, 0, 0};
  g.oh = conv_out(h, padh, kh, csh);
  g.ow = conv_out(w, padw, kw, csw);
  g.ph = pool_out(g.oh, pkh, psh);
  g.pw = pool_out(g.ow, pkw, psw);
  return g;
}

// ---- K1's tile: a run of pooled rows, all pooled columns ----------------
//
// A CTA of K1 takes pooled rows [p0, p0 + r).  It computes every conv value
// those rows' windows read — conv rows [conv_pos(p0, psh, 0), + span) by
// conv columns [0, span) — from the input rows and columns those conv
// values read, staged with the padding as zeros, a chunk of input channels
// at a time.

// Conv (or input) positions that `n` consecutive windows of `k` at stride
// `s` cover: (n - 1) * s + k.  Pooled rows -> conv rows with (pkh, psh);
// conv rows -> input rows with (kh, csh); the same along columns.
CP_HD int span(int n, int k, int s) { return (n - 1) * s + k; }

// Where a tile's staged input starts (unpadded coordinates, may be
// negative): row in_origin(conv_pos(p0, psh, 0)), column -padw.
CP_HD int tile_in_row0(int p0, int psh, int csh, int padh) {
  return in_origin(conv_pos(p0, psh, 0), csh, padh);
}

struct Tile {
  int rows;   // pooled rows of this tile (the last tile may be shorter)
  int crows;  // conv rows it computes
  int ccols;  // conv columns it computes (the same for every tile)
  int hrows;  // input rows it stages
  int wcols;  // input columns it stages
};

CP_HD Tile make_tile(const Geom& g, int rows) {
  Tile t;
  t.rows = rows;
  t.crows = span(rows, g.pkh, g.psh);
  t.ccols = span(g.pw, g.pkw, g.psw);
  t.hrows = span(t.crows, g.kh, g.csh);
  t.wcols = span(t.ccols, g.kw, g.csw);
  return t;
}

// f32 words rounded up to a whole 16-byte line, so each part of K1's
// shared memory starts 16-byte aligned.
CP_HD long long words16(long long n) { return (n + 3) / 4 * 4; }

// K1's shared memory for tiles of `rows` pooled rows and `ct` output
// channels staging `cc` input channels at a time, all f32 (bf16 is widened
// as it is staged): the channel tile's weights over every input channel, one
// chunk of staged input (cc x hrows x wcols) and the conv tile
// (ct x crows x ccols).
CP_HD long long k1_smem_bytes(const Geom& g, int rows, int ct, int cc) {
  const Tile t = make_tile(g, rows);
  return 4 * (words16(static_cast<long long>(ct) * g.cin * g.kh * g.kw) +
              words16(static_cast<long long>(cc) * t.hrows * t.wcols) +
              words16(static_cast<long long>(ct) * t.crows * t.ccols));
}

// ---- K2's tile: K1's, staged as int8 with the channels innermost --------
//
// K2 stages its weights as (channels of the tile, taps, input channels) and
// its input as (input rows, input columns, input channels), 4 int8 channels
// a 32-bit word (zero-padded to whole words), so one __dp4a takes 4
// channels; its conv tile holds int32 sums.

// 32-bit words one staged input position takes for `cc` channels, made odd
// so neighbouring positions fall in distinct shared-memory banks.
CP_HD int k2_pos_words(int cc) { return ((cc + 3) / 4) | 1; }

// K2's shared memory for tiles of `rows` pooled rows and `ct` output
// channels staging `cc` input channels at a time: the tile's int8 weights
// over every input channel, one chunk of staged int8 input and the int32
// conv tile, each part 16-byte aligned.
CP_HD long long k2_smem_bytes(const Geom& g, int rows, int ct, int cc) {
  const Tile t = make_tile(g, rows);
  return 4 * (words16(static_cast<long long>(ct) * g.kh * g.kw * ((g.cin + 3) / 4)) +
              words16(static_cast<long long>(t.hrows) * t.wcols * k2_pos_words(cc)) +
              words16(static_cast<long long>(ct) * t.crows * t.ccols));
}

}  // namespace cp
