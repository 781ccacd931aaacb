// AC-strategy entropy estimates ("kernel E"): persistent warps, one family
// each.
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
// Bound on the H100: by the byte count, memory (at 8 MP, 135 groups, the
// three coefficient sets are 3 x 106 MB read once: 0.095 ms at 3.35 TB/s),
// but the instructions are nearly as many: ~32 for each of the 79.6 M
// coefficient-channel values in this design's SASS (~22 of arithmetic, none
// of it fused, ~10 of loads, sums and stores). What limits the kernel is
// how many of those a multiprocessor issues a clock, so the design keeps
// the work around the arithmetic small:
//   - the square root of |rint(val)|, an integer-valued float, is
//     fast_math.cuh's branch-free in-range sequence, 0 selected for 0. Its
//     range holds every finite value, so the test (inf, NaN) is one
//     __all_sync a warp item, and an item that fails is computed again with
//     sqrtf. nvcc's own sqrtf puts a branch to its slow path round every
//     root, which fences the coefficients' chains off from each other;
//   - a warp is persistent over one family (blockIdx.y): it keeps its lanes'
//     12 quant weights in registers for the whole grid-stride loop;
//   - every lane holds 4 coefficients of a cell: an 8x8 cell takes 16 lanes
//     (a warp item is two neighbouring cells), a 16x8 / 8x16 cell 32. Lane l
//     of a cell holds coefficients l + L*i (L lanes a cell, i < 4): each load
//     instruction reads 64 or 128 contiguous bytes a cell, and the Y values
//     stay in registers for the CfL term of X and B;
//   - the cell's eight sums (entropy and info loss of three channels, the
//     packed nonzero counts, a spare) are reduced together by a butterfly:
//     at each level a lane keeps half of its values and adds its partner's
//     copy of that half, so a 16x8 cell takes 9 shuffles (not 30 and three
//     integer reductions) and two 8x8 cells take 8 between them; six lanes
//     store the six results.
// Every float sum is the halving tree x[i] + x[i + n/2] of the plain version
// (tree_sum): the first two levels pair a lane's own elements (i with i+2,
// then 0 with 1), the rest pair lanes L/2 .. 1 apart inside the cell's
// lanes, whichever of the two keeps the value (a + b == b + a exactly), so
// kernel and plain version agree bit for bit (built with -fmad=false
// -prec-sqrt=true; rintf rounds half to even like torch.round). The nonzero
// counts ride as n0 + 256 n1 + 65536 n2 in a float: integers below 2^24,
// whose sums are exact in any order.

#include <cuda_runtime.h>

#include "fast_math.cuh"

namespace {

constexpr float K_ABOVE15 = 4.4628149885273363f;
constexpr float K_SQRT = 5.3359184934516337f;
constexpr float K_NBITS = 7.565053364251793f;
constexpr float K_IL = 138.0f;
constexpr float FLOAT_MAX = 3.40282347e38f;
constexpr int WARPS = 8;          // warps a CTA
constexpr int CTAS_PER_SM = 5;    // one wave of CTAs: 40 warps a multiprocessor, 48 registers
constexpr bool FAST_SQRT = true;  // false: every root through sqrtf
constexpr unsigned FULL = 0xffffffffu;

// ceil(log2(v)) for v >= 1, exact.
__device__ __forceinline__ int ceil_log2(int v) {
  return v <= 1 ? 0 : 32 - __clz(v - 1);
}

// One lane's share of a warp item: 4 coefficients a channel of its cell and
// the cell's scalars.
struct Item {
  float x[3][4];
  float q, mk, cfx, cfb;
};

// L lanes a cell, CPG cells a group (a power of two), S = 4 * L coefficients
// a cell. Cell gc = item * (32 / L) + h of the family, h = lane / L.
template <int L, int CPG>
__device__ __forceinline__ void load_item(const float* __restrict__ coef,
                                          const float* __restrict__ q,
                                          const float* __restrict__ m,
                                          const float* __restrict__ fac, unsigned item,
                                          int h, int li, Item& it) {
  constexpr int S = 4 * L;
  const unsigned gc = item * (32 / L) + h;
  const unsigned g = gc / CPG, c = gc % CPG;
  const float* base = coef + ((size_t)g * 3 * CPG + c) * S + li;
#pragma unroll
  for (int ch = 0; ch < 3; ++ch) {
#pragma unroll
    for (int i = 0; i < 4; ++i) it.x[ch][i] = __ldg(base + ch * CPG * S + L * i);
  }
  it.q = __ldg(q + gc);
  it.mk = __ldg(m + gc) * K_IL;
  it.cfx = __ldg(fac + g * 2 * CPG + c);
  it.cfb = __ldg(fac + g * 2 * CPG + CPG + c);
}

// The lane's 12 quant weights: coefficient li + L*i of each channel.
template <int L>
__device__ __forceinline__ void load_qm(const float* __restrict__ qm_g, int li,
                                        float (&qm)[3][4]) {
#pragma unroll
  for (int ch = 0; ch < 3; ++ch) {
#pragma unroll
    for (int i = 0; i < 4; ++i) qm[ch][i] = __ldg(qm_g + ch * 4 * L + li + L * i);
  }
}

// The lane's partial sums of the item's three channels, in v: entropy terms
// of channels 0..2, info-loss terms of channels 0..2, and the three nonzero
// counts packed as n0 + 256 n1 + 65536 n2 (integers below 2^24, so every
// float sum of them is exact), then 0. Each partial is the first two levels
// of the halving tree: element i of the lane is coefficient li + L*i, so
// pairs S/2 apart are i and i + 2, pairs S/4 = L apart 0 and 1. Returns
// whether every |rint(val)| of this lane was in FAST's range.
template <bool FAST>
__device__ __forceinline__ bool partials(const Item& it, const float (&qm)[3][4],
                                         float k_nz, float (&v)[8]) {
  bool ok = true;
  int packed = 0;
#pragma unroll
  for (int ch = 0; ch < 3; ++ch) {
    const float cf = ch == 0 ? it.cfx : (ch == 2 ? it.cfb : 0.0f);
    float e[4], d2[4];
    int n = 0;
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const float val = (it.x[ch][i] - cf * it.x[1][i]) * qm[ch][i] * it.q;
      const float rval = rintf(val);
      const float diff = fabsf(val - rval);
      const float aq = fabsf(rval);
      const bool nonzero = aq != 0.0f;
      n += nonzero ? 1 : 0;
      float root;
      if (FAST) {
        ok = ok && aq <= FLOAT_MAX;  // false for infinity and NaN
        root = nonzero ? square_root<true>(aq) : 0.0f;
      } else {
        root = sqrtf(aq);
      }
      e[i] = (aq >= 1.5f ? K_ABOVE15 : 0.0f) + root * K_SQRT +
             (nonzero ? k_nz : 0.0f) + it.mk * diff;
      d2[i] = diff * diff;
    }
    v[ch] = (e[0] + e[2]) + (e[1] + e[3]);
    v[3 + ch] = (d2[0] + d2[2]) + (d2[1] + d2[3]);
    packed += n << (8 * ch);
  }
  v[6] = (float)packed;
  v[7] = 0.0f;
  return ok;
}

// One butterfly level over lanes `off` apart: a lane keeps the half of its
// M values that its side owns and adds the partner's copy of that half.
// Pairs are exactly the halving tree's (a + b == b + a in IEEE arithmetic).
template <int M>
__device__ __forceinline__ void fold(float (&v)[8], int lane, int off) {
  const bool upper = (lane & off) != 0;
#pragma unroll
  for (int k = 0; k < M / 2; ++k) {
    const float send = upper ? v[k] : v[k + M / 2];
    const float keep = upper ? v[k + M / 2] : v[k];
    v[k] = keep + __shfl_xor_sync(FULL, send, off);
  }
}

// The remaining tree levels over the cell's L lanes (L/2 .. 1 apart); lane
// l ends with the full sum of value (l / (L/8)) % 8 in v[0].
template <int L>
__device__ __forceinline__ void reduce(float (&v)[8], int lane) {
  fold<8>(v, lane, L / 2);
  fold<4>(v, lane, L / 4);
  fold<2>(v, lane, L / 8);
#pragma unroll
  for (int off = L / 16; off >= 1; off /= 2) v[0] = v[0] + __shfl_xor_sync(FULL, v[0], off);
}

// A warp's grid-stride walk over one family's items.
template <int L, int CPG>
__device__ __forceinline__ void walk(const float* __restrict__ coef,
                                     const float* __restrict__ q,
                                     const float* __restrict__ m,
                                     const float* __restrict__ fac,
                                     const float* __restrict__ qm_g,
                                     float* __restrict__ out, unsigned items, float k_nz) {
  const int lane = threadIdx.x & 31, h = lane / L, li = lane % L;
  const int value = (lane / (L / 8)) % 8;  // the sum this lane ends with
  unsigned item = blockIdx.x * WARPS + (threadIdx.x >> 5);
  if (item >= items) return;
  const unsigned stride = gridDim.x * WARPS;
  float qm[3][4];
  load_qm<L>(qm_g, li, qm);
  Item cur;
  load_item<L, CPG>(coef, q, m, fac, item, h, li, cur);
  // The next item is loaded at the end of the loop, after the stores: as a
  // for loop with the load at its head, nvcc spills and the kernel takes
  // 17% longer (tools/bench_strategy_bitpack).
  while (true) {
    float v[8];
    if (!__all_sync(FULL, partials<FAST_SQRT>(cur, qm, k_nz, v))) {
      // Rare (an infinite or NaN value): the item again, with sqrtf, from
      // fresh loads, so that no register holds the item past the fast path.
      Item again;
      float qm_again[3][4];
      load_item<L, CPG>(coef, q, m, fac, item, h, li, again);
      load_qm<L>(qm_g, li, qm_again);
      partials<false>(again, qm_again, k_nz, v);
    }
    reduce<L>(v, lane);
    // The packed counts sit with value 6 (lanes h*L + 6*(L/8) ...).
    const int counts = (int)__shfl_sync(FULL, v[0], h * L + 6 * (L / 8));
    if (li % (L / 8) == 0 && value < 6) {
      const unsigned gc = item * (32 / L) + h;
      float* o = out + (size_t)(gc / CPG) * 6 * CPG + gc % CPG;
      if (value < 3) {
        const int nbits = ceil_log2(((counts >> (8 * value)) & 255) + 1) + 1;
        o[2 * value * CPG] = v[0] + K_NBITS * (float)(ceil_log2(nbits + 17) + nbits);
      } else {
        o[(2 * (value - 3) + 1) * CPG] = v[0];
      }
    }
    item += stride;
    if (item >= items) break;
    load_item<L, CPG>(coef, q, m, fac, item, h, li, cur);
  }
}

// blockIdx.y: 0 = 8x8 cells (items of two cells), 1 = 16x8, 2 = 8x16.
__global__ void __launch_bounds__(WARPS * 32, CTAS_PER_SM)
strategy_kernel(const float* __restrict__ coef8, const float* __restrict__ coef_v,
                const float* __restrict__ coef_h, const float* __restrict__ q8,
                const float* __restrict__ qv, const float* __restrict__ qh,
                const float* __restrict__ m8, const float* __restrict__ mv,
                const float* __restrict__ mh, const float* __restrict__ fac8,
                const float* __restrict__ facv, const float* __restrict__ fach,
                const float* __restrict__ qm8, const float* __restrict__ qm16,
                float* __restrict__ p8, float* __restrict__ pv,
                float* __restrict__ ph, int groups, float k_nz) {
  // unsigned items and cells (item * 2 + h for the 8x8 family): exact up
  // to 4,194,303 groups (cells < 2^32); pointer offsets are size_t.
  const unsigned items = (unsigned)groups * 512;
  if (blockIdx.y == 0) {
    walk<16, 1024>(coef8, q8, m8, fac8, qm8, p8, items, k_nz);
  } else {
    const bool vert = blockIdx.y == 1;
    walk<32, 512>(vert ? coef_v : coef_h, vert ? qv : qh, vert ? mv : mh,
                  vert ? facv : fach, qm16, vert ? pv : ph, items, k_nz);
  }
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
    int dev = 0, sms = 0;
    cudaGetDevice(&dev);
    cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
    // Every family has groups * 512 items of the same work; together the
    // three fill one wave of CTAS_PER_SM CTAs a multiprocessor.
    const long long want = ((long long)groups * 512 + WARPS - 1) / WARPS;
    const long long wave = ((long long)(sms > 0 ? sms : 1) * CTAS_PER_SM + 2) / 3;
    const dim3 grid((unsigned)(want < wave ? want : wave), 3);
    strategy_kernel<<<grid, WARPS * 32, 0, (cudaStream_t)stream>>>(
        coef8, coef_v, coef_h, q8, qv, qh, m8, mv, mh, fac8, facv, fach, qm8,
        qm16, p8, pv, ph, groups, k_nz);
  }
  return (int)cudaGetLastError();
}
