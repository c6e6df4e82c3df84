// Host build of flash_mask.cuh for the CPU tests: a C ABI over the exact
// lines K5's two kernels run to pick their key blocks and mask them, so a
// plain C++ compiler (no nvcc) can hold them against the plain version.
//
//   g++ -O2 -shared -fPIC -o libflash_mask.so flash_mask_host.cpp
#include "flash_mask.cuh"

extern "C" {

int fm_visible(int kj, int qi, int T, int q_offset, int causal, int window) {
  return fm::visible(kj, qi, T, q_offset, causal, window) ? 1 : 0;
}

// [out2[0], out2[1]): the keys a CTA of query rows [q0, q0 + bq) reads.
void fm_key_range(int T, int q_offset, int q0, int bq, int bk, int causal, int window,
                  int* out2) {
  out2[0] = fm::key_begin(q_offset, q0, window, bk);
  out2[1] = fm::key_end(T, q_offset, q0, bq, causal);
}

// The (S, T) mask a K5 launch applies, as its CTAs walk it: for each block of
// bq query rows, the key blocks of bk keys from key_begin to key_end, each
// element of an edge block masked by `visible`, every element of another
// block kept; keys no block reaches stay 0.  out is row-major, S * T bytes.
void fm_kernel_mask(int S, int T, int q_offset, int causal, int window, int bq, int bk,
                    unsigned char* out) {
  for (long long e = 0; e < static_cast<long long>(S) * T; ++e) out[e] = 0;
  for (int q0 = 0; q0 < S; q0 += bq) {
    const int kend = fm::key_end(T, q_offset, q0, bq, causal);
    for (int k0 = fm::key_begin(q_offset, q0, window, bk); k0 < kend; k0 += bk) {
      const bool edge = fm::edge(k0, bk, T, q_offset, q0, bq, causal, window);
      for (int qi = q0; qi < q0 + bq && qi < S; ++qi)
        for (int kj = k0; kj < k0 + bk && kj < T; ++kj)
          out[static_cast<long long>(qi) * T + kj] =
              !edge || fm::visible(kj, qi, T, q_offset, causal, window);
    }
  }
}
}
