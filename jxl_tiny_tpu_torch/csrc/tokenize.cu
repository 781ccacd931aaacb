// Per-coefficient tokenization: one warp per 128-lane emission row, four
// lanes a thread.
//
// Replaces the Pallas TPU kernel jxl_tiny_tpu/ops/tokenize_kernel.py:
// _tok_kernel (reached through tokenize_cells). Plain torch version:
// jxl_tiny_tpu_torch/ops/tokenize_kernel.py:tokenize_rows_plain. Integer
// arithmetic only, so the two agree exactly.
//
// The TPU kernel took the inclusive nonzero prefix count as a triangular
// matmul on the MXU and the neighbour lanes as rolls; here the prefix is a
// warp scan (shuffles) over the threads' 4-lane partial counts, the
// previous-nonzero bit comes from the thread to the left by one shuffle,
// and each thread computes its lanes plus the next lane (4t + 4) itself
// for the covered=2 slot shift.
//
// Bound on the H100: memory. Every row is read once (128 i32 + one meta
// word) and written once: 212 MB in and 212 MB out for 135 groups, ~127 us
// at 3.35 TB/s. Loads and stores are 16 B a thread, consecutive threads on
// consecutive addresses.

#include <cuda_runtime.h>

namespace {

constexpr int ROWS_PER_CTA = 8;  // one warp each

struct Row {
  int cov, nztot, block_ctx, prev_init, first;
  bool cov2;
};

// Token fields of lane k (before the covered=2 shift).
__device__ __forceinline__ int lane_token(int k, int x, int nzv, int cum,
                                          int prev_nz, const Row& r,
                                          const int* __restrict__ freq,
                                          int thresh) {
  const bool in_range = k >= r.cov && k < r.cov * 64;
  const int nz_left = r.nztot - cum + nzv;
  const int prev = k == r.cov ? r.prev_init : prev_nz;
  const int nzl_shift = r.cov2 ? (nz_left + 1) >> 1 : nz_left;
  const int freq_sel = freq[(r.cov2 ? 128 : 0) + k];
  const int q = nzl_shift >= thresh ? 5 : min(freq_sel, 5);
  const int ctx = 16 + r.block_ctx * 12 + q * 2 + prev;
  const bool valid = in_range && nz_left > 0 && r.first > 0;
  const int val = x >= 0 ? 2 * x : -2 * x - 1;
  return valid ? (ctx << 16) | val : 0;
}

__global__ void __launch_bounds__(32 * ROWS_PER_CTA)
tokenize_kernel(const int* __restrict__ xs, const int* __restrict__ metas,
                const int* __restrict__ freq, int* __restrict__ out, int n,
                int thresh) {
  const int warp = threadIdx.x >> 5, t = threadIdx.x & 31;
  // int row of n = groups * 3072 rows: exact up to 699,050 groups
  // (n < 2^31); the row's offset is size_t.
  const int row = blockIdx.x * ROWS_PER_CTA + warp;
  if (row >= n) return;  // whole warp exits together
  const int meta = metas[row];
  Row r;
  r.cov = (meta & 1) + 1;
  r.nztot = (meta >> 1) & 127;
  r.block_ctx = (meta >> 8) & 15;
  const int nzero_ctx = (meta >> 12) & 63;
  r.prev_init = (meta >> 18) & 1;
  r.first = (meta >> 19) & 1;
  r.cov2 = r.cov == 2;

  const int* xr = xs + (size_t)row * 128;
  const int4 v4 = reinterpret_cast<const int4*>(xr)[t];
  int x[5] = {v4.x, v4.y, v4.z, v4.w, t < 31 ? xr[4 * t + 4] : 0};
  int nzv[5];
  for (int m = 0; m < 5; ++m) {
    const int k = 4 * t + m;
    nzv[m] = (x[m] != 0 && k >= r.cov && k < r.cov * 64) ? 1 : 0;
  }
  int part[4];
  part[0] = nzv[0];
  for (int m = 1; m < 4; ++m) part[m] = part[m - 1] + nzv[m];
  // Warp inclusive scan of the 4-lane totals.
  int incl = part[3];
  for (int d = 1; d < 32; d <<= 1) {
    const int up = __shfl_up_sync(0xffffffffu, incl, d);
    if (t >= d) incl += up;
  }
  const int excl = incl - part[3];
  const int left_nz = __shfl_up_sync(0xffffffffu, nzv[3], 1);
  const int prev_of_first = t == 0 ? 0 : left_nz;  // nzv at lane 4t - 1

  int tok[5];
  for (int m = 0; m < 5; ++m) {
    const int k = 4 * t + m;
    const int cum = m < 4 ? excl + part[m] : excl + part[3] + nzv[4];
    const int prev_nz = m == 0 ? prev_of_first : nzv[m - 1];
    tok[m] = (m == 4 && t == 31) ? 0
             : lane_token(k, x[m], nzv[m], cum, prev_nz, r, freq, thresh);
  }
  int o[4];
  for (int m = 0; m < 4; ++m) o[m] = r.cov2 ? tok[m + 1] : tok[m];
  if (t == 0) o[0] = (nzero_ctx << 16) | r.nztot;
  reinterpret_cast<int4*>(out + (size_t)row * 128)[t] = make_int4(o[0], o[1], o[2], o[3]);
}

}  // namespace

extern "C" int tokenize_launch(const int* x, const int* meta, const int* freq,
                               int* out, int n, int thresh, void* stream) {
  if (n > 0)
    tokenize_kernel<<<(n + ROWS_PER_CTA - 1) / ROWS_PER_CTA, 32 * ROWS_PER_CTA,
                      0, (cudaStream_t)stream>>>(x, meta, freq, out, n, thresh);
  return (int)cudaGetLastError();
}
