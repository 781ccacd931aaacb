// Fused quantize ("kernel F"): one warp per 2x2 quad of 8x8 cells, no block
// barrier.
//
// Replaces the Pallas TPU kernel jxl_tiny_tpu/ops/quantize_kernel.py:
// _quant_kernel (reached through quantize_cells). Plain torch version:
// jxl_tiny_tpu_torch/ops/quantize_kernel.py:quantize_cells_plain. Bit-equal
// to it: only IEEE * / and rintf (round half to even, as jnp.round) touch
// the floats, and the file is built with -fmad=false.
//
// Bound on the H100: memory. 135 groups read 106 MB of coefficients (each
// cell's 3 x 64, from the 8x8 set or from the 16x8 / 8x16 set its pair
// shares) and write 212 MB of ordered values (~95 us at 3.35 TB/s).
//
// Design. A warp owns an aligned 2x2 quad of cells, so both cells of any
// 16x8 (vertical) or 8x16 (horizontal) pair are in one warp. Lanes 0..3
// read the four cells' strategy, quant field and CfL factors; shuffles hand
// them round. A cell whose pair partner has the same strategy, quant field
// and factors computes the very same 128 values from the same 128
// coefficients, so the warp computes them once and stores them to both
// cells' rows (maps are free to mix strategies, or to disagree inside a
// pair: then every cell is computed on its own, as the plain version does).
// Per computed cell:
//   - the natural coefficients (3 x 64, or 3 x 128 for a pair) come in as
//     coalesced 16-byte streaming loads into the warp's 1.5 KB of shared
//     memory; DCT8 cells get zeros in the upper half, which is what the
//     plain version gathers there;
//   - lane l owns zig-zag positions 4l..4l+3: it reads its four natural
//     indices (one packed word) and its table entries, which tables.py
//     keeps already permuted into zig-zag order, as 16-byte loads that stay
//     in L1, gathers its coefficients from shared memory, and keeps the
//     Y -> X/B dependency (the dequantized Y that CfL subtracts) to itself;
//   - each of the three emission rows ([G,32,32,3(Y,X,B),128] int32) is one
//     16-byte streaming store a lane, 512 B a warp;
//   - nonzero counts and last nonzero positions are warp reductions, the DC
//     pairs come by shuffle from the lanes that hold natural coefficients 0
//     and 1. __syncwarp() around the staging is the only synchronisation.
// The scalars arrive as a kernel parameter (constant bank), not as a tensor.

#include <cuda_runtime.h>

namespace {

// Scalars of one quantization setting; ops/quantize_kernel.py:_Params fills
// the same layout (11 floats, then the zig-zag positions of natural
// coefficients 0 and 1 for each strategy).
struct Params {
  float scale, x_qm_mul, inv_factor[3], cfl_b, bias[4], sc;
  int dc_pos[3][2];
};

constexpr int DCT8 = 0, DCT16X8 = 1, DCT8X16 = 2;
constexpr float AC_CLAMP = 32767.0f;
constexpr float DC_CLAMP = 16383.0f;
constexpr int WARPS = 4;  // quads a CTA
constexpr unsigned FULL = 0xffffffffu;

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

__device__ __forceinline__ float pick(const float v[4], int e) {
  return e == 0 ? v[0] : (e == 1 ? v[1] : (e == 2 ? v[2] : v[3]));
}

__device__ __forceinline__ void store4(int* p, const int q[4]) {
  __stcs(reinterpret_cast<int4*>(p), make_int4(q[0], q[1], q[2], q[3]));
}

// Tables in zig-zag order: qm_zz, thr_zz [3 strategies][3 channels][128];
// dqm_zz [3][128] (Y only); order_zz [3][32] words of four natural indices.
__global__ void __launch_bounds__(WARPS * 32)
quantize_kernel(const float* __restrict__ coef8, const float* __restrict__ coef_v,
                const float* __restrict__ coef_h, const int* __restrict__ strategy,
                const int* __restrict__ raw_qf, const float* __restrict__ fac_x,
                const float* __restrict__ fac_b, const float4* __restrict__ qm_zz,
                const float4* __restrict__ thr_zz, const float4* __restrict__ dqm_zz,
                const unsigned* __restrict__ order_zz, int* __restrict__ ordered,
                int* __restrict__ nz_out, int* __restrict__ qdc_out,
                int* __restrict__ lastnz_out, int quads, const Params P) {
  __shared__ __align__(16) float stage[WARPS][3 * 128];
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  // int quad and int g * 1024 + cell below: exact up to 2,097,151 groups
  // (2^21 - 1); the coefficient and output offsets are size_t.
  const int quad = blockIdx.x * WARPS + warp;  // g * 256 + qy * 16 + qx
  if (quad >= quads) return;
  const int g = quad >> 8, qy = (quad >> 4) & 15, qx = quad & 15;
  float* sm = stage[warp];

  // Lane c < 4 reads the maps of cell c = dy * 2 + dx of the quad.
  const int my_cell = (2 * qy + ((lane >> 1) & 1)) * 32 + 2 * qx + (lane & 1);
  int s_l = 0, q_l = 0, fx_l = 0, fb_l = 0;
  if (lane < 4) {
    const int o = g * 1024 + my_cell;
    s_l = strategy[o];
    q_l = raw_qf[o];
    fx_l = __float_as_int(fac_x[o]);
    fb_l = __float_as_int(fac_b[o]);
  }
  // A cell follows its pair's first cell when both have the pair's strategy
  // and the same quant field and factors: cell c ^ 2 for a vertical pair,
  // c ^ 1 for a horizontal one.
  // (Every lane takes part in every shuffle: none sits behind a short-circuit.)
  const bool eq_v = s_l == __shfl_xor_sync(FULL, s_l, 2) &
                    q_l == __shfl_xor_sync(FULL, q_l, 2) &
                    fx_l == __shfl_xor_sync(FULL, fx_l, 2) &
                    fb_l == __shfl_xor_sync(FULL, fb_l, 2);
  const bool eq_h = s_l == __shfl_xor_sync(FULL, s_l, 1) &
                    q_l == __shfl_xor_sync(FULL, q_l, 1) &
                    fx_l == __shfl_xor_sync(FULL, fx_l, 1) &
                    fb_l == __shfl_xor_sync(FULL, fb_l, 1);
  const bool same_v = lane < 4 && s_l == DCT16X8 && eq_v;
  const bool same_h = lane < 4 && s_l == DCT8X16 && eq_h;
  // partner_l: the other cell of the quad that takes this cell's values
  // too, or -1; follows_l: this cell is written by its pair's first cell.
  const int partner_l = same_v ? (lane ^ 2) : (same_h ? (lane ^ 1) : -1);
  const bool follows_l = (same_v && (lane & 2)) || (same_h && (lane & 1));

#pragma unroll 1
  for (int c = 0; c < 4; ++c) {
    if (__shfl_sync(FULL, (int)follows_l, c)) continue;
    const int s = __shfl_sync(FULL, s_l, c);
    const float quant = (float)__shfl_sync(FULL, q_l, c);
    const float fx = __int_as_float(__shfl_sync(FULL, fx_l, c));
    const float fb = __int_as_float(__shfl_sync(FULL, fb_l, c));
    const int partner = __shfl_sync(FULL, partner_l, c);
    const int by = 2 * qy + (c >> 1), bx = 2 * qx + (c & 1);

    // Stage the natural coefficients of X, Y, B: [3][128] floats.
    float4* sm4 = reinterpret_cast<float4*>(sm);
    if (s == DCT8) {
      for (int idx = lane; idx < 48; idx += 32) {
        const int ch = idx >> 4, k = idx & 15;
        const size_t row = (((size_t)g * 3 + ch) * 32 + by) * 32 + bx;
        sm4[ch * 32 + k] = __ldcs(reinterpret_cast<const float4*>(coef8 + row * 64) + k);
        sm4[ch * 32 + 16 + k] = make_float4(0.f, 0.f, 0.f, 0.f);
      }
    } else {
#pragma unroll
      for (int ch = 0; ch < 3; ++ch) {
        const size_t gc = (size_t)g * 3 + ch;
        const float* src =
            s == DCT16X8 ? coef_v + ((gc * 16 + (by >> 1)) * 32 + bx) * 128
                         : coef_h + ((gc * 32 + by) * 16 + (bx >> 1)) * 128;
        sm4[ch * 32 + lane] = __ldcs(reinterpret_cast<const float4*>(src) + lane);
      }
    }
    __syncwarp();

    const float qac = quant * P.scale;
    const float inv_qac = 1.0f / (quant * P.scale);
    const unsigned nat4 = __ldg(order_zz + s * 32 + lane);
    const float4* tq = qm_zz + s * 96 + lane;  // + 32 a channel
    const float4* tt = thr_zz + s * 96 + lane;
    const float4 qmx4 = __ldg(tq), qmy4 = __ldg(tq + 32), qmb4 = __ldg(tq + 64);
    const float4 thx4 = __ldg(tt), thy4 = __ldg(tt + 32), thb4 = __ldg(tt + 64);
    const float4 dqy4 = __ldg(dqm_zz + s * 32 + lane);
    const float qmx[4] = {qmx4.x, qmx4.y, qmx4.z, qmx4.w};
    const float qmy[4] = {qmy4.x, qmy4.y, qmy4.z, qmy4.w};
    const float qmb[4] = {qmb4.x, qmb4.y, qmb4.z, qmb4.w};
    const float thx[4] = {thx4.x, thx4.y, thx4.z, thx4.w};
    const float thy[4] = {thy4.x, thy4.y, thy4.z, thy4.w};
    const float thb[4] = {thb4.x, thb4.y, thb4.z, thb4.w};
    const float dqy[4] = {dqy4.x, dqy4.y, dqy4.z, dqy4.w};

    const int cov = s == DCT8 ? 1 : 2;
    int qx4[4], qy4[4], qb4[4];
    float cxs[4], cys[4], cbs[4];  // the coefficients after CfL (DC pairs)
    int cnt[3] = {0, 0, 0}, last[3] = {0, 0, 0};
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      const int i = (nat4 >> (8 * e)) & 0xff;
      const float c_x = sm[i], c_y = sm[128 + i], c_b = sm[256 + i];
      const int qyv = quantize(c_y, qmy[e], thy[e], qac * 1.0f);
      const float qyf = (float)qyv;
      float sel;
      if (fabsf(qyf) < 1.125f)
        sel = qyv == 0 ? 0.0f : (qyf < 0.0f ? -P.bias[1] : P.bias[1]);
      else
        sel = qyf - P.bias[3] / (qyv == 0 ? 1.0f : qyf);
      const float y_deq = sel * dqy[e] * inv_qac;
      const float cx = c_x - fx * y_deq;
      const float cb = c_b - fb * y_deq;
      qy4[e] = qyv;
      qx4[e] = quantize(cx, qmx[e], thx[e], qac * P.x_qm_mul);
      qb4[e] = quantize(cb, qmb[e], thb[e], qac * 1.0f);
      cxs[e] = cx; cys[e] = c_y; cbs[e] = cb;
      const int j = 4 * lane + e;
      if (j >= cov && j < cov * 64) {
        if (qx4[e] != 0) { ++cnt[0]; last[0] = j; }
        if (qy4[e] != 0) { ++cnt[1]; last[1] = j; }
        if (qb4[e] != 0) { ++cnt[2]; last[2] = j; }
      }
    }
    __syncwarp();  // the staging area is free for the next cell

    // Emission layout [G,32,32,3(Y,X,B),128], to this cell and its partner.
    const int cell = by * 32 + bx;
    const int pcell = partner < 0 ? -1
                                  : (2 * qy + (partner >> 1)) * 32 + 2 * qx + (partner & 1);
    int* o = ordered + ((size_t)g * 1024 + cell) * 384 + 4 * lane;
    store4(o, qy4); store4(o + 128, qx4); store4(o + 256, qb4);
    if (pcell >= 0) {
      int* o2 = ordered + ((size_t)g * 1024 + pcell) * 384 + 4 * lane;
      store4(o2, qy4); store4(o2 + 128, qx4); store4(o2 + 256, qb4);
    }

    // Natural coefficients 0 and 1 of each channel, from the lanes that
    // hold them (every lane gets all six).
    float dc[3][2];
#pragma unroll
    for (int k = 0; k < 2; ++k) {
      const int pos = s == DCT8 ? P.dc_pos[0][k]
                                : (s == DCT16X8 ? P.dc_pos[1][k] : P.dc_pos[2][k]);
      dc[0][k] = __shfl_sync(FULL, pick(cxs, pos & 3), pos >> 2);
      dc[1][k] = __shfl_sync(FULL, pick(cys, pos & 3), pos >> 2);
      dc[2][k] = __shfl_sync(FULL, pick(cbs, pos & 3), pos >> 2);
    }
#pragma unroll
    for (int ch = 0; ch < 3; ++ch) {
      cnt[ch] = __reduce_add_sync(FULL, cnt[ch]);
      last[ch] = __reduce_max_sync(FULL, last[ch]);
    }
    if (lane < 3) {
      const int ch = lane;
      const int n_ch = ch == 0 ? cnt[0] : (ch == 1 ? cnt[1] : cnt[2]);
      const int l_ch = ch == 0 ? last[0] : (ch == 1 ? last[1] : last[2]);
      // DC pairs: (c0 + c1 * sc for two-cell transforms, else c0; c0 - c1 * sc).
      const float c0 = ch == 0 ? dc[0][0] : (ch == 1 ? dc[1][0] : dc[2][0]);
      const float c1 = (ch == 0 ? dc[0][1] : (ch == 1 ? dc[1][1] : dc[2][1])) * P.sc;
      const float first = s != DCT8 ? c0 + c1 : c0;
      const float second = c0 - c1;
      const float invf = ch == 0 ? P.inv_factor[0]
                                 : (ch == 1 ? P.inv_factor[1] : P.inv_factor[2]);
      int d0, d1;
      if (ch == 2) {
        // DC-CfL for B subtracts the quantized Y DC (needs Y's pair).
        const float y0 = dc[1][0], y1 = dc[1][1] * P.sc;
        const float yf = s != DCT8 ? y0 + y1 : y0;
        const float ys = y0 - y1;
        const int qy0 = dc_clip(round_away(yf * P.inv_factor[1]));
        const int qy1 = dc_clip(round_away(ys * P.inv_factor[1]));
        d0 = dc_clip(round_away(first * invf - (float)qy0 * P.cfl_b));
        d1 = dc_clip(round_away(second * invf - (float)qy1 * P.cfl_b));
      } else {
        d0 = dc_clip(round_away(first * invf));
        d1 = dc_clip(round_away(second * invf));
      }
      const size_t gch = (size_t)g * 3 + ch;
      nz_out[gch * 1024 + cell] = n_ch;
      lastnz_out[gch * 1024 + cell] = l_ch;
      qdc_out[gch * 2048 + cell] = d0;
      qdc_out[gch * 2048 + 1024 + cell] = d1;
      if (pcell >= 0) {
        nz_out[gch * 1024 + pcell] = n_ch;
        lastnz_out[gch * 1024 + pcell] = l_ch;
        qdc_out[gch * 2048 + pcell] = d0;
        qdc_out[gch * 2048 + 1024 + pcell] = d1;
      }
    }
  }
}

}  // namespace

// `params` is a host pointer to a Params; it travels to the card as a
// kernel parameter.
extern "C" int quantize_launch(const float* coef8, const float* coef_v,
                               const float* coef_h, const int* strategy,
                               const int* raw_qf, const float* fac_x,
                               const float* fac_b, const float* qm_zz,
                               const float* thr_zz, const float* dqm_zz,
                               const int* order_zz, int* ordered, int* nz,
                               int* qdc, int* lastnz, int groups,
                               const void* params, void* stream) {
  const Params P = *static_cast<const Params*>(params);
  const int quads = groups * 256;
  if (groups > 0)
    quantize_kernel<<<(quads + WARPS - 1) / WARPS, WARPS * 32, 0,
                      (cudaStream_t)stream>>>(
        coef8, coef_v, coef_h, strategy, raw_qf, fac_x, fac_b,
        reinterpret_cast<const float4*>(qm_zz),
        reinterpret_cast<const float4*>(thr_zz),
        reinterpret_cast<const float4*>(dqm_zz),
        reinterpret_cast<const unsigned*>(order_zz), ordered, nz, qdc, lastnz,
        quads, P);
  return (int)cudaGetLastError();
}
