// Fused quantize ("kernel F"): one CTA of 128 threads per 8x8 cell.
//
// Replaces the Pallas TPU kernel jxl_tiny_tpu/ops/quantize_kernel.py:
// _quant_kernel (reached through quantize_cells). Plain torch version:
// jxl_tiny_tpu_torch/ops/quantize_kernel.py:quantize_cells_plain. Bit-equal
// to it: only IEEE * / and rintf (round half to even, as jnp.round) touch
// the floats, and the file is built with -fmad=false.
//
// Thread j owns zig-zag position j of the cell: it reads the natural
// coefficient order[strategy][j] of the strategy's coefficient set (the
// 8x8 DCT, or the 16x8 / 8x16 transform shared by a cell pair), so the
// zig-zag reorder is an index permutation instead of the TPU's one-hot
// matmuls, and the Y -> X/B dependency (the dequantized Y value that CfL
// subtracts) stays inside the thread. Nonzero counts come from a block
// vote, the last nonzero position from warp max-reductions, the DC pairs
// from the natural coefficients 0 and 1 that two threads leave in shared
// memory.
//
// Bound on the H100: memory. 135 groups read 106 MB of DCT8 coefficients
// (the 16x8/8x16 sets, at full size, another 212 MB when the strategy
// search is on) and write 212 MB of ordered values (~95 us at 3.35 TB/s
// for the DCT8-only encode). Coalescing: consecutive threads write
// consecutive ordered values; reads follow the zig-zag permutation inside
// one 256 B (or 512 B) row, so each warp still touches few sectors.

#include <cuda_runtime.h>

namespace {

enum { K_SCALE, K_XQM, K_INVF0, K_INVF1, K_INVF2, K_CFLB, K_B0, K_B1, K_B2,
       K_B3, K_SC, N_K };

constexpr int DCT8 = 0, DCT16X8 = 1;
constexpr float AC_CLAMP = 32767.0f;
constexpr float DC_CLAMP = 16383.0f;

__device__ __forceinline__ int quantize(float coef, float qm, float thr,
                                        float qmul) {
  const float val = coef * qm * qmul;
  float q = fabsf(val) >= thr ? rintf(val) : 0.0f;
  q = fminf(fmaxf(q, -AC_CLAMP), AC_CLAMP);
  return (int)q;
}

__device__ __forceinline__ float round_away(float x) {
  const float r = floorf(fabsf(x) + 0.5f);
  return x > 0.0f ? r : (x < 0.0f ? -r : 0.0f);
}

__device__ __forceinline__ int dc_clip(float v) {
  return (int)fminf(fmaxf(v, -DC_CLAMP), DC_CLAMP);
}

__global__ void __launch_bounds__(128)
quantize_kernel(const float* __restrict__ coef8, const float* __restrict__ coef_v,
                const float* __restrict__ coef_h, const int* __restrict__ strategy,
                const int* __restrict__ raw_qf, const float* __restrict__ fac_x,
                const float* __restrict__ fac_b, const float* __restrict__ qm_tab,
                const float* __restrict__ dqm_tab, const float* __restrict__ thr_tab,
                const int* __restrict__ order_tab, int* __restrict__ ordered,
                int* __restrict__ nz_out, int* __restrict__ qdc_out,
                int* __restrict__ lastnz_out, const float* __restrict__ kc) {
  __shared__ float k[N_K];
  __shared__ float dc[3][2];   // natural coefficients 0, 1 of X, Y, B
  __shared__ int wmax[3][4];   // per-warp last nonzero position
  const int cell_g = blockIdx.x;  // g * 1024 + by * 32 + bx
  const int g = cell_g >> 10, cell = cell_g & 1023;
  const int by = cell >> 5, bx = cell & 31;
  const int j = threadIdx.x;
  if (j < N_K) k[j] = kc[j];
  __syncthreads();

  const int s = strategy[cell_g];
  const int i = order_tab[s * 128 + j];
  float c[3];
  for (int ch = 0; ch < 3; ++ch) {
    const size_t gc = (size_t)g * 3 + ch;
    if (s == DCT8)
      c[ch] = i < 64 ? coef8[((gc * 32 + by) * 32 + bx) * 64 + i] : 0.0f;
    else if (s == DCT16X8)
      c[ch] = coef_v[((gc * 16 + (by >> 1)) * 32 + bx) * 128 + i];
    else
      c[ch] = coef_h[((gc * 32 + by) * 16 + (bx >> 1)) * 128 + i];
  }
  const float quant = (float)raw_qf[cell_g];
  const float qac = quant * k[K_SCALE];
  const float inv_qac = 1.0f / (quant * k[K_SCALE]);
  const int t = s * 384 + i;  // tables [strategy][channel][128]

  const int qy = quantize(c[1], qm_tab[t + 128], thr_tab[t + 128], qac * 1.0f);
  const float qyf = (float)qy;
  float sel;
  if (fabsf(qyf) < 1.125f)
    sel = qy == 0 ? 0.0f : (qyf < 0.0f ? -k[K_B1] : k[K_B1]);
  else
    sel = qyf - k[K_B3] / (qy == 0 ? 1.0f : qyf);
  const float y_deq = sel * dqm_tab[t + 128] * inv_qac;
  const float cx = c[0] - fac_x[cell_g] * y_deq;
  const float cb = c[2] - fac_b[cell_g] * y_deq;
  const int qx = quantize(cx, qm_tab[t], thr_tab[t], qac * k[K_XQM]);
  const int qb = quantize(cb, qm_tab[t + 256], thr_tab[t + 256], qac * 1.0f);

  if (i < 2) {
    dc[0][i] = cx;
    dc[1][i] = c[1];
    dc[2][i] = cb;
  }
  // Emission layout [G,32,32,3(Y,X,B),128].
  int* o = ordered + (size_t)cell_g * 384 + j;
  o[0] = qy;
  o[128] = qx;
  o[256] = qb;

  const int cov = s == DCT8 ? 1 : 2;
  const bool in_range = j >= cov && j < cov * 64;
  const int q3[3] = {qx, qy, qb};
  const int lane = j & 31, warp = j >> 5;
  int cnt[3];
  for (int ch = 0; ch < 3; ++ch) {
    const bool nzm = in_range && q3[ch] != 0;
    cnt[ch] = __syncthreads_count(nzm);
    const int m = __reduce_max_sync(0xffffffffu, nzm ? (unsigned)j : 0u);
    if (lane == 0) wmax[ch][warp] = m;
  }
  __syncthreads();
  if (j < 3) {
    const int ch = j;
    const int m = max(max(wmax[ch][0], wmax[ch][1]), max(wmax[ch][2], wmax[ch][3]));
    const size_t mo = ((size_t)g * 3 + ch) * 1024 + cell;
    nz_out[mo] = cnt[ch];
    lastnz_out[mo] = m;
    // DC pairs: (c0 + c1 * sc for two-cell transforms, else c0; c0 - c1 * sc).
    const float c0 = dc[ch][0];
    const float c1 = dc[ch][1] * k[K_SC];
    const float first = s != DCT8 ? c0 + c1 : c0;
    const float second = c0 - c1;
    const float invf = k[K_INVF0 + ch];
    int d0, d1;
    if (ch == 2) {
      // DC-CfL for B subtracts the quantized Y DC (needs Y's pair).
      const float y0 = dc[1][0], y1 = dc[1][1] * k[K_SC];
      const float yf = s != DCT8 ? y0 + y1 : y0;
      const float ys = y0 - y1;
      const int qy0 = dc_clip(round_away(yf * k[K_INVF1]));
      const int qy1 = dc_clip(round_away(ys * k[K_INVF1]));
      d0 = dc_clip(round_away(first * invf - (float)qy0 * k[K_CFLB]));
      d1 = dc_clip(round_away(second * invf - (float)qy1 * k[K_CFLB]));
    } else {
      d0 = dc_clip(round_away(first * invf));
      d1 = dc_clip(round_away(second * invf));
    }
    const size_t qo = (((size_t)g * 3 + ch) * 2) * 1024 + cell;
    qdc_out[qo] = d0;
    qdc_out[qo + 1024] = d1;
  }
}

}  // namespace

extern "C" int quantize_launch(const float* coef8, const float* coef_v,
                               const float* coef_h, const int* strategy,
                               const int* raw_qf, const float* fac_x,
                               const float* fac_b, const float* qm_tab,
                               const float* dqm_tab, const float* thr_tab,
                               const int* order_tab, int* ordered, int* nz,
                               int* qdc, int* lastnz, int groups,
                               const float* consts, void* stream) {
  if (groups > 0)
    quantize_kernel<<<groups * 1024, 128, 0, (cudaStream_t)stream>>>(
        coef8, coef_v, coef_h, strategy, raw_qf, fac_x, fac_b, qm_tab, dqm_tab,
        thr_tab, order_tab, ordered, nz, qdc, lastnz, consts);
  return (int)cudaGetLastError();
}
