// Host build of conv_pool_math.cuh for the CPU tests: a C ABI over the exact
// lines the kernels run, so a plain C++ compiler (no nvcc) can hold the
// requantization and the geometry against the reference package.
//
//   g++ -O2 -shared -fPIC -o libconv_pool_math.so conv_pool_math_host.cpp
#include "conv_pool_math.cuh"

extern "C" {

// out[i] = requant(acc[i], m[i]) for i < n.
void cp_requant(const int32_t* acc, const float* m, int8_t* out, long long n) {
  for (long long i = 0; i < n; ++i) out[i] = cp::requant(acc[i], m[i]);
}

// Per-channel requant of a contiguous (N, C, H, W) int32 block of n
// elements, hw = H*W: out[i] = requant(acc[i], m[channel of i]).
void cp_requant_per_channel(const int32_t* acc, const float* m, int8_t* out,
                            long long n, int c, int hw) {
  for (long long i = 0; i < n; ++i)
    out[i] = cp::requant_per_channel(acc[i], m, cp::nchw_channel(i, c, hw));
}

// (oh, ow, ph, pw) of one fused conv+pool geometry.
void cp_geom(int h, int w, int kh, int kw, int csh, int csw, int padh, int padw,
             int pkh, int pkw, int psh, int psw, int* out4) {
  const cp::Geom g = cp::make_geom(1, 1, h, w, 1, kh, kw, csh, csw, padh, padw,
                                   pkh, pkw, psh, psw);
  out4[0] = g.oh;
  out4[1] = g.ow;
  out4[2] = g.ph;
  out4[3] = g.pw;
}

// Input rows [lo, hi] that pooled row `p` reads, before clipping to the
// image: the halo a row tile of the kernels touches.
void cp_pooled_row_span(int p, int kh, int csh, int padh, int pkh, int psh,
                        int* lo_hi) {
  lo_hi[0] = cp::in_origin(cp::conv_pos(p, psh, 0), csh, padh);
  lo_hi[1] = cp::in_origin(cp::conv_pos(p, psh, pkh - 1), csh, padh) + kh - 1;
}

int cp_in_bounds(int i, int n) { return cp::in_bounds(i, n) ? 1 : 0; }

// K1's tile of `rows` pooled rows starting at pooled row p0 (clipped to the
// image's last pooled row, as the kernel clips it): out6 = (first conv row,
// conv rows, conv columns, first input row, input rows, input columns).
void cp_k1_tile(int h, int w, int kh, int kw, int csh, int csw, int padh, int padw,
                int pkh, int pkw, int psh, int psw, int p0, int rows, int* out6) {
  const cp::Geom g = cp::make_geom(1, 1, h, w, 1, kh, kw, csh, csw, padh, padw,
                                   pkh, pkw, psh, psw);
  const cp::Tile t = cp::make_tile(g, rows < g.ph - p0 ? rows : g.ph - p0);
  out6[0] = cp::conv_pos(p0, psh, 0);
  out6[1] = t.crows;
  out6[2] = t.ccols;
  out6[3] = cp::tile_in_row0(p0, psh, csh, padh);
  out6[4] = t.hrows;
  out6[5] = t.wcols;
}

// K1's shared memory in bytes for tiles of `rows` pooled rows and `ct`
// output channels, staging `cc` input channels at a time.
long long cp_k1_smem_bytes(int cin, int h, int w, int cout, int kh, int kw, int csh,
                           int csw, int padh, int padw, int pkh, int pkw, int psh,
                           int psw, int rows, int ct, int cc) {
  const cp::Geom g = cp::make_geom(1, cin, h, w, cout, kh, kw, csh, csw, padh, padw,
                                   pkh, pkw, psh, psw);
  return cp::k1_smem_bytes(g, rows, ct, cc);
}

// K2's shared memory in bytes for tiles of `rows` pooled rows and `ct`
// output channels, staging `cc` input channels at a time.
long long cp_k2_smem_bytes(int cin, int h, int w, int cout, int kh, int kw, int csh,
                           int csw, int padh, int padw, int pkh, int pkw, int psh,
                           int psw, int rows, int ct, int cc) {
  const cp::Geom g = cp::make_geom(1, cin, h, w, cout, kh, kw, csh, csw, padh, padw,
                                   pkh, pkw, psh, psw);
  return cp::k2_smem_bytes(g, rows, ct, cc);
}
}
