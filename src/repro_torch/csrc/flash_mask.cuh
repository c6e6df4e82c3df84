// K5's key range and mask (flash_fwd.cu): which keys a query row may see,
// which key blocks a block of query rows reads, and which of those blocks
// need the per-element mask.
//
// Query row i of a call sits at position q_offset + i (a data row's span of a
// sequence split over the data axes starts at q_offset; a whole sequence at
// 0).  It may see key j when j < T, when causal j <= q_offset + i, and with a
// window w > 0 j > q_offset + i - w.  Only the mask and the key range take
// the offset: q and o rows stay local to the call.
//
// Everything here is __host__ __device__ so that a plain C++ compiler can
// build the host side into a small library (flash_mask_host.cpp) and the CPU
// tests can hold it against the plain version's mask; nvcc builds the same
// lines into both kernels.
#pragma once

#if defined(__CUDACC__)
#define FM_HD __host__ __device__ __forceinline__
#else
#define FM_HD inline
#endif

namespace fm {

// Whether query row qi (local to the call) may see key kj.
FM_HD bool visible(int kj, int qi, int T, int q_offset, int causal, int window) {
  const int pos = q_offset + qi;
  return kj < T && (!causal || kj <= pos) && (window == 0 || kj > pos - window);
}

// One past the last key that query rows [q0, q0 + bq) may see.
FM_HD int key_end(int T, int q_offset, int q0, int bq, int causal) {
  if (!causal) return T;
  const int last = q_offset + q0 + bq;  // no key after the block's last row
  return last < T ? last : T;
}

// The first key block (of bk keys, from 0) that query rows [q0, q0 + bq)
// may see: the window's first key rounded down to a block.
FM_HD int key_begin(int q_offset, int q0, int window, int bk) {
  int first = window ? q_offset + q0 - window + 1 : 0;
  if (first < 0) first = 0;
  return (first / bk) * bk;
}

// Whether keys [k0, k0 + bk) hold one that some row of [q0, q0 + bq) may not
// see: past T, above the diagonal of the block's first row, or before the
// window of its last.  A block that is not an edge needs no mask.
FM_HD bool edge(int k0, int bk, int T, int q_offset, int q0, int bq, int causal,
                int window) {
  return k0 + bk > T || (causal && k0 + bk - 1 > q_offset + q0) ||
         (window && k0 < q_offset + q0 + bq - window);
}

}  // namespace fm
