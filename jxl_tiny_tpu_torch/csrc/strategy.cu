// AC-strategy entropy estimates ("kernel E"): one warp per candidate cell.
//
// Replaces the Pallas TPU kernel jxl_tiny_tpu/ops/strategy_kernel.py:
// _estimate_kernel (reached through estimate_partials). Plain torch
// version: jxl_tiny_tpu_torch/ops/strategy_kernel.py:estimate_partials_plain.
//
// For each group, channel and family (8x8 cells of 64 coefficients, 16x8
// and 8x16 cells of 128) and each cell, with val = (c - cf*y) * qm * q,
// rval = rint(val), diff = |val - rval|:
//   ent = sum(K_ABOVE15*[|rval| >= 1.5] + K_SQRT*sqrt(|rval|)
//             + k_nz*[rval != 0] + (m*138)*diff)
//         + K_NBITS*(ceil_log2(nbits + 17) + nbits),
//         nbits = ceil_log2(nzeros + 1) + 1
//   il2 = sum(diff*diff)
// written in raster cell order as p[g, channel, (ent, il2), row, col].
//
// A warp owns one cell. Lane l holds coefficients l, l+32 (and l+64, l+96
// for 128), so every load instruction of the warp reads 128 contiguous
// bytes; the Y row stays in registers for the CfL term of X and B, so each
// coefficient set is read once. The sums are the halving tree
// x[i] + x[i + n/2]: first inside the lane, then by shuffle-down, which is
// the order the plain version spells out, so both agree bit for bit (built
// with -fmad=false, -prec-sqrt=true; rintf rounds half to even like
// torch.round). The nonzero count is an integer sum and exact. The TPU
// kernel's two-cells-per-128-lane packing and its even/odd output order
// were answers to Mosaic's lane rules and have no counterpart here.
//
// Bound on the H100: memory. At 8 MP (135 groups) the three coefficient
// sets are 3 x 106 MB read once, against ~20 operations a coefficient.
// One launch covers the three families: blocks of 8 warps walk the cells,
// 8 consecutive cells of a row a block, so a block's outputs fill whole
// 32-byte sectors.

#include <cuda_runtime.h>

namespace {

constexpr float K_ABOVE15 = 4.4628149885273363f;
constexpr float K_SQRT = 5.3359184934516337f;
constexpr float K_NBITS = 7.565053364251793f;
constexpr float K_IL = 138.0f;
constexpr int WARPS = 8;
constexpr unsigned FULL = 0xffffffffu;

// ceil(log2(v)) for v >= 1, exact.
__device__ __forceinline__ int ceil_log2(int v) {
  return v <= 1 ? 0 : 32 - __clz(v - 1);
}

// One cell of S = 32 * N coefficients; the warp's lanes hold N each.
template <int N>
__device__ __forceinline__ void cell(const float* __restrict__ coef,  // [3][cells][S] of this group
                                     size_t chan_stride, size_t cell_off,
                                     const float* __restrict__ qm,  // [3][S]
                                     float q, float mk, float cfx, float cfb,
                                     float k_nz, float* __restrict__ out,
                                     size_t out_chan_stride, size_t out_map_stride,
                                     int lane) {
  constexpr int S = 32 * N;
  float y[N];
#pragma unroll
  for (int i = 0; i < N; ++i) y[i] = coef[chan_stride + cell_off + lane + 32 * i];
#pragma unroll
  for (int ch = 0; ch < 3; ++ch) {
    const float cf = ch == 0 ? cfx : (ch == 2 ? cfb : 0.0f);
    float e[N], d2[N];
    int nz = 0;
#pragma unroll
    for (int i = 0; i < N; ++i) {
      const float c = ch == 1 ? y[i] : coef[ch * chan_stride + cell_off + lane + 32 * i];
      const float val = (c - cf * y[i]) * qm[ch * S + lane + 32 * i] * q;
      const float rval = rintf(val);
      const float diff = fabsf(val - rval);
      const float aq = fabsf(rval);
      const bool nonzero = aq != 0.0f;
      nz += nonzero ? 1 : 0;
      e[i] = (aq >= 1.5f ? K_ABOVE15 : 0.0f) + sqrtf(aq) * K_SQRT +
             (nonzero ? k_nz : 0.0f) + mk * diff;
      d2[i] = diff * diff;
    }
    // Halving tree inside the lane: element j of the lane is coefficient
    // lane + 32*j, so x[i] + x[i + S/2] pairs j with j + N/2.
#pragma unroll
    for (int h = N / 2; h >= 1; h /= 2) {
#pragma unroll
      for (int i = 0; i < h; ++i) {
        e[i] = e[i] + e[i + h];
        d2[i] = d2[i] + d2[i + h];
      }
    }
    float es = e[0], ds = d2[0];
#pragma unroll
    for (int off = 16; off >= 1; off /= 2) {
      es = es + __shfl_down_sync(FULL, es, off);
      ds = ds + __shfl_down_sync(FULL, ds, off);
    }
    nz = __reduce_add_sync(FULL, nz);
    if (lane == 0) {
      const int nbits = ceil_log2(nz + 1) + 1;
      const float tail = K_NBITS * (float)(ceil_log2(nbits + 17) + nbits);
      out[ch * out_chan_stride] = es + tail;
      out[ch * out_chan_stride + out_map_stride] = ds;
    }
  }
}

__global__ void __launch_bounds__(WARPS * 32)
strategy_kernel(const float* __restrict__ coef8, const float* __restrict__ coef_v,
                const float* __restrict__ coef_h, const float* __restrict__ q8,
                const float* __restrict__ qv, const float* __restrict__ qh,
                const float* __restrict__ m8, const float* __restrict__ mv,
                const float* __restrict__ mh, const float* __restrict__ fac8,
                const float* __restrict__ facv, const float* __restrict__ fach,
                const float* __restrict__ qm8, const float* __restrict__ qm16,
                float* __restrict__ p8, float* __restrict__ pv,
                float* __restrict__ ph, int groups, float k_nz) {
  const int lane = threadIdx.x & 31;
  // Global cell index over [8x8: G*1024 | 16x8: G*512 | 8x16: G*512]; the
  // family boundaries are multiples of the 8 cells a block covers.
  size_t w = (size_t)blockIdx.x * WARPS + (threadIdx.x >> 5);
  const size_t n8 = (size_t)groups * 1024, n16 = (size_t)groups * 512;
  if (w < n8) {
    const size_t g = w >> 10, c = w & 1023;
    cell<2>(coef8 + g * 3 * 1024 * 64, (size_t)1024 * 64, c * 64, qm8, q8[w],
            m8[w] * K_IL, fac8[g * 2048 + c], fac8[g * 2048 + 1024 + c], k_nz,
            p8 + g * 6 * 1024 + c, (size_t)2 * 1024, 1024, lane);
    return;
  }
  w -= n8;
  const bool vert = w < n16;
  if (!vert) w -= n16;
  if (w >= n16) return;
  const size_t g = w >> 9, c = w & 511;
  cell<4>((vert ? coef_v : coef_h) + g * 3 * 512 * 128, (size_t)512 * 128, c * 128,
          qm16, (vert ? qv : qh)[w], (vert ? mv : mh)[w] * K_IL,
          (vert ? facv : fach)[g * 1024 + c], (vert ? facv : fach)[g * 1024 + 512 + c],
          k_nz, (vert ? pv : ph) + g * 6 * 512 + c, (size_t)2 * 512, 512, lane);
}

}  // namespace

extern "C" int strategy_launch(const float* coef8, const float* coef_v,
                               const float* coef_h, const float* q8,
                               const float* qv, const float* qh, const float* m8,
                               const float* mv, const float* mh, const float* fac8,
                               const float* facv, const float* fach,
                               const float* qm8, const float* qm16, float* p8,
                               float* pv, float* ph, int groups, float k_nz,
                               void* stream) {
  if (groups > 0) {
    const unsigned blocks = (unsigned)(((size_t)groups * 2048 + WARPS - 1) / WARPS);
    strategy_kernel<<<blocks, WARPS * 32, 0, (cudaStream_t)stream>>>(
        coef8, coef_v, coef_h, q8, qv, qh, m8, mv, mh, fac8, facv, fach, qm8,
        qm16, p8, pv, ph, groups, k_nz);
  }
  return (int)cudaGetLastError();
}
