// The exactness probe's two kernels (jxl_tiny_tpu_torch/tools/
// probe_op_exactness.py): how the card's compiled float ops round, and
// whether the card's int8 tensor-core path sums exactly.
//
// probe_elementwise replaces tools/probe_op_exactness.py:pallas_elementwise
// (its pl.pallas_call at :36): one float op applied elementwise, compiled by
// nvcc at the flags the library was built with (ops/probe_kernels.FLAG_SETS)
// rather than by the framework; float32 in and out. The op is a template
// parameter (11 instantiations; the host picks one), so an element's path
// holds its one expression and no branch. Each op's expression is written as
// before this design, so each of the three builds contracts (or does not)
// exactly what it did: with the port's flags (-fmad=false -prec-div=true
// -prec-sqrt=true) every op but cbrt equals torch on the card bit for bit.
// Bound: bytes (each input read once, the output written once). Design:
// 16-byte float4 loads and stores when every pointer is 16-byte aligned, with
// a scalar n % 4 tail; scalar accesses for a misaligned start; a grid of
// multiprocessors x resident blocks x EW_WAVES walks the data with a
// grid-stride loop. Div, on NVIDIA H100 80GB HBM3 at 700.00 W (chip_smoke.py
// phase 8): 0.0030 ms at the probe's 2^19 values (the old one-thread-an-
// element kernel with a runtime switch 0.0035, torch.div 0.0031) and 0.0998
// ms at [3,2160,3840] (89% of its 0.0891 ms bound; torch.div 0.0999).
// Plain torch version: ops/probe_kernels.probe_elementwise_plain.
//
// probe_dot_i8 replaces tools/probe_op_exactness.py:kern_i8 (its
// pl.pallas_call at :152), which asked whether the TPU's matrix unit lowers
// an int8 product with int32 sums and sums it exactly: [M, K] int8 x [K, N]
// int8 -> [M, N] int32, any M, K, N >= 1. Here the products run on the int8
// tensor cores as mma.sync.aligned.m16n8k32.row.col.s32.s8.s8.s32 (IMMA in
// the SASS; chip_smoke.py checks it). mma.sync and not wgmma: at the shape
// that matters, one permutation chunk of the JAX quantizer's JXL_ZZ_INT8
// zig-zag over photo8mp ([414720,128] x [128,128]), the kernel is bound by
// bytes (53.1 MB in, 212.3 MB out: 0.0792 ms at 3.35 TB/s), not by
// operations (0.0069 ms at 1,979 int8 TOP/s), so mma.sync's rate is ample
// and wgmma's warpgroup tiles and descriptors would buy nothing. Design:
//   - persistent CTAs (multiprocessors x 2) walk 64-row x 128-column output
//     tiles, column tile outer, so a CTA's B stays put while its A moves;
//   - B's [128 k x 128 n] chunk is transposed to K-major in shared memory
//     (sm_90 has no 8-bit ldmatrix.trans), with 16-byte row loads where N %
//     16 == 0, while A's first chunks are in flight; every warp then keeps
//     its B fragments in registers. K is taken in chunks of 128 and N in
//     tiles of 128, tails zero-padded; B is staged again only when a CTA's
//     chunk changes;
//   - A's 64 x 128 chunks stream through a 3-stage cp.async ring (16-byte
//     copies, zero-filled past M and K) while the previous tiles' products
//     and stores run; a K that is not a multiple of 16 or a misaligned A
//     takes byte loads instead;
//   - 8 warps each own a 32 x 32 block (2 x 4 fragments of 16 x 8); the
//     accumulators go through a per-warp shared-memory tile so that the
//     int32 output, 80% of the bytes, leaves as coalesced 16-byte rows with
//     evict-first stores (scalar stores where N % 4 != 0 or the output is
//     misaligned).
// On NVIDIA H100 80GB HBM3 at 700.00 W (chip_smoke.py phase 8): 0.1025 ms
// at the zig-zag chunk (77% of its bound; torch._int_mm 0.1523; the old
// one-thread-an-output CUDA-core kernel could not launch there, M > 65,535
// grid rows, and took 1.93 ms over row slices, tools/bench_probe.py) and
// 0.0046 ms at the probe's [256,128] x [128,128] (old 0.0073; launch-bound).
// Integer sums are exact, so the plain version (ops/probe_kernels.
// probe_dot_i8_plain, int32 sums over K in torch) must equal it exactly.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

enum Op {
  OP_EXP2 = 0, OP_LOG2, OP_SQRT, OP_RSQRT, OP_DIV, OP_RECIP, OP_MUL_ADD,
  OP_CBRT, OP_AQ_TAIL, OP_EXP, OP_LOG,
};

constexpr int kMaxDevices = 64;

int sm_count() {
  static int cached[kMaxDevices];
  int dev = 0;
  cudaGetDevice(&dev);
  if (dev < kMaxDevices && cached[dev]) return cached[dev];
  int v = 0;
  cudaDeviceGetAttribute(&v, cudaDevAttrMultiProcessorCount, dev);
  if (dev < kMaxDevices) cached[dev] = v;
  return v;
}

// ---- probe_elementwise --------------------------------------------------

constexpr int EW_THREADS = 256;
// The grid: multiprocessors x resident blocks x EW_WAVES. One resident wave
// (1,056 blocks) read 85% of the div bound at [3,2160,3840], 16 waves 89%,
// torch.div's share (tools/bench_probe.py, NVIDIA H100 80GB HBM3, 700.00 W).
constexpr int EW_WAVES = 16;

template <int OP>
__device__ __forceinline__ float apply(float x, float y, float z) {
  if constexpr (OP == OP_EXP2) return exp2f(x);
  else if constexpr (OP == OP_LOG2) return log2f(x);
  else if constexpr (OP == OP_SQRT) return sqrtf(x);
  else if constexpr (OP == OP_RSQRT) return rsqrtf(x);
  else if constexpr (OP == OP_DIV) return x / y;
  else if constexpr (OP == OP_RECIP) return 1.0f / x;
  else if constexpr (OP == OP_MUL_ADD) return x * y + z;
  else if constexpr (OP == OP_CBRT) return cbrtf(x);
  // The AQ field's tail as the kernels write it: exp2(v * log2e) * m + a.
  else if constexpr (OP == OP_AQ_TAIL) return exp2f(x * 1.442695041f) * 0.7f + 0.1f;
  else if constexpr (OP == OP_EXP) return expf(x);
  else return logf(x);
}

template <int OP>
constexpr int kInputs = OP == OP_DIV ? 2 : OP == OP_MUL_ADD ? 3 : 1;

// Elements [0, 4 * body) as float4 (body = 0 unless every pointer is 16-byte
// aligned), [4 * body, n) one at a time: loads through the read-only path,
// evict-first stores (2% faster than plain stores at 2^19 values,
// tools/bench_probe.py, NVIDIA H100 80GB HBM3, 700.00 W).
template <int OP>
__global__ void __launch_bounds__(EW_THREADS)
probe_elementwise_kernel(const float* __restrict__ a, const float* __restrict__ b,
                         const float* __restrict__ c, float* __restrict__ out, int n,
                         int body) {
  constexpr int NIN = kInputs<OP>;
  const int tid = blockIdx.x * EW_THREADS + threadIdx.x;
  const int stride = gridDim.x * EW_THREADS;
  const float4* a4 = reinterpret_cast<const float4*>(a);
  const float4* b4 = reinterpret_cast<const float4*>(b);
  const float4* c4 = reinterpret_cast<const float4*>(c);
  float4* o4 = reinterpret_cast<float4*>(out);
  for (int i = tid; i < body; i += stride) {
    const float4 x = __ldg(a4 + i);
    const float4 y = NIN > 1 ? __ldg(b4 + i) : x;
    const float4 z = NIN > 2 ? __ldg(c4 + i) : x;
    float4 r;
    r.x = apply<OP>(x.x, y.x, z.x);
    r.y = apply<OP>(x.y, y.y, z.y);
    r.z = apply<OP>(x.z, y.z, z.z);
    r.w = apply<OP>(x.w, y.w, z.w);
    __stcs(o4 + i, r);
  }
  for (long long i = 4LL * body + tid; i < n; i += stride)
    out[i] = apply<OP>(a[i], NIN > 1 ? b[i] : 0.0f, NIN > 2 ? c[i] : 0.0f);
}

template <int OP>
int launch_elementwise(const float* a, const float* b, const float* c, float* out, int n,
                       cudaStream_t stream) {
  constexpr int NIN = kInputs<OP>;
  static int resident = 0;  // blocks of this instantiation an SM holds
  if (!resident)
    cudaOccupancyMaxActiveBlocksPerMultiprocessor(&resident, probe_elementwise_kernel<OP>,
                                                  EW_THREADS, 0);
  uintptr_t mis = reinterpret_cast<uintptr_t>(a) | reinterpret_cast<uintptr_t>(out);
  if (NIN > 1) mis |= reinterpret_cast<uintptr_t>(b);
  if (NIN > 2) mis |= reinterpret_cast<uintptr_t>(c);
  const int body = (mis & 15) == 0 ? n / 4 : 0;
  const long long work = body > 0 ? body : n;  // units the grid-stride loop walks
  long long blocks = (work + EW_THREADS - 1) / EW_THREADS;
  const long long cap = (long long)sm_count() * (resident > 0 ? resident : 1) * EW_WAVES;
  if (blocks > cap) blocks = cap;
  probe_elementwise_kernel<OP><<<(int)blocks, EW_THREADS, 0, stream>>>(a, b, c, out, n, body);
  return (int)cudaGetLastError();
}

// ---- probe_dot_i8 ------------------------------------------------------

constexpr int BM = 64;           // CTA tile rows
constexpr int BN = 128;          // CTA tile columns
constexpr int KC = 128;          // k bytes of a chunk
constexpr int STAGES = 3;        // A ring depth
constexpr int DOT_THREADS = 256; // 8 warps: 2 (rows) x 4 (columns) of 32 x 32
constexpr int ROW = KC + 16;     // shared row stride (bytes) of A and B^T: ldmatrix conflict-free
constexpr int CST = 40;          // staging row stride (int32): 8-byte fragment stores conflict-free
constexpr int A_BYTES = BM * ROW;
constexpr int B_BYTES = BN * ROW;
constexpr int C_BYTES = (DOT_THREADS / 32) * 32 * CST * 4;
constexpr int DOT_SMEM = STAGES * A_BYTES + B_BYTES + C_BYTES;  // 87,040 B: 2 CTAs an SM
static_assert(BM * KC / 16 % DOT_THREADS == 0 && BN * KC / 4 % DOT_THREADS == 0 &&
              (KC / 4) * (BN / 16) == DOT_THREADS, "whole copy rounds a thread");

__device__ __forceinline__ uint32_t smem_addr(const void* p) {
  return (uint32_t)__cvta_generic_to_shared(p);
}

__device__ __forceinline__ void cp_async16(void* dst, const void* src, int src_bytes) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(smem_addr(dst)),
               "l"(src), "r"(src_bytes) : "memory");
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}

template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N) : "memory");
}

__device__ __forceinline__ void ldmatrix_x4(uint32_t (&r)[4], const void* p) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0, %1, %2, %3}, [%4];\n"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
               : "r"(smem_addr(p)) : "memory");
}

// d += a (16 x 32, row) * b (32 x 8, col), int8 in, int32 sums.
__device__ __forceinline__ void mma_s8(int (&d)[4], const uint32_t (&a)[4],
                                       const uint32_t (&b)[2]) {
  asm volatile(
      "mma.sync.aligned.m16n8k32.row.col.s32.s8.s8.s32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+r"(d[0]), "+r"(d[1]), "+r"(d[2]), "+r"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b[0]), "r"(b[1]));
}

// kVecA: A is 16-byte aligned and K % 16 == 0 (cp.async rows); kVecOut: the
// output is 16-byte aligned and N % 4 == 0 (16-byte stores).
// vec_b: B is 16-byte aligned and N % 16 == 0 (16-byte row loads).
template <bool kVecA, bool kVecOut>
__global__ void __launch_bounds__(DOT_THREADS, 2)
probe_dot_i8_kernel(const int8_t* __restrict__ a, const int8_t* __restrict__ b,
                    int32_t* __restrict__ out, int m, int k, int n, bool vec_b) {
  extern __shared__ __align__(128) unsigned char smem[];
  unsigned char* sa = smem;                    // STAGES x [BM][ROW]: A chunks
  unsigned char* sb = smem + STAGES * A_BYTES; // [BN][ROW]: B^T chunk, K-major
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int wm = warp >> 2, wn = warp & 3;     // the warp's 32 x 32 block
  const int g = lane >> 2, t = lane & 3;       // fragment row group, thread in group
  int32_t* sc = reinterpret_cast<int32_t*>(sb + B_BYTES) + warp * 32 * CST;

  const int mt = (m + BM - 1) / BM, nt = (n + BN - 1) / BN;
  const int nk = (k + KC - 1) / KC;
  const int units = mt * nt;
  const int my_units = (int)blockIdx.x < units ? (units - 1 - (int)blockIdx.x) / gridDim.x + 1 : 0;
  const int steps = my_units * nk;  // (unit, k chunk) pairs, k chunk inner

  // A's chunk of step s into ring stage s % STAGES (always one commit group).
  auto load_a = [&](int s) {
    if (s < steps) {
      const int u = blockIdx.x + (s / nk) * gridDim.x;
      const int m0 = (u % mt) * BM, k0 = (s % nk) * KC;
      unsigned char* dst = sa + (s % STAGES) * A_BYTES;
      if constexpr (kVecA) {
#pragma unroll
        for (int q = 0; q < BM * KC / 16 / DOT_THREADS; ++q) {
          const int p = tid + q * DOT_THREADS;
          const int r = p / (KC / 16), col = (p % (KC / 16)) * 16;
          const bool ok = m0 + r < m && k0 + col < k;
          cp_async16(dst + r * ROW + col, ok ? a + (size_t)(m0 + r) * k + k0 + col : a,
                     ok ? 16 : 0);
        }
      } else {
        for (int q = 0; q < BM * KC / 4 / DOT_THREADS; ++q) {
          const int p = tid + q * DOT_THREADS;
          const int r = p / (KC / 4), col = (p % (KC / 4)) * 4;
          uint32_t w = 0;
          if (m0 + r < m) {
            const int8_t* src = a + (size_t)(m0 + r) * k;
#pragma unroll
            for (int j = 0; j < 4; ++j)
              if (k0 + col + j < k) w |= (uint32_t)(uint8_t)src[k0 + col + j] << (8 * j);
          }
          *reinterpret_cast<uint32_t*>(dst + r * ROW + col) = w;
        }
      }
    }
    cp_async_commit();
  };

  uint32_t bf[KC / 32][4][2];  // B fragments: k step of 32, n8 tile, register
  int acc[2][4][4];            // m16 tile, n8 tile, fragment
  int b_key = -1;              // (column tile, k chunk) whose fragments bf holds

  // B[k0 : k0 + KC, n0 : n0 + BN] of `key` to sb[n][k] (K-major: a word
  // holds 4 k of one n), then every warp's fragments from sb into bf. All
  // threads call it together, after every warp is done with the old bf.
  auto load_b = [&](int key) {
    const int n0 = (key / nk) * BN, k0 = (key % nk) * KC;
    if (vec_b) {
      // A thread's 4 k rows x 16 n: four 16-byte loads, 16 words out.
      const int kq = (tid / (BN / 16)) * 4, nn = (tid % (BN / 16)) * 16;
      uint4 rows[4];
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const bool ok = k0 + kq + j < k && n0 + nn < n;
        rows[j] = ok ? __ldg(reinterpret_cast<const uint4*>(b + (size_t)(k0 + kq + j) * n + n0 + nn))
                     : make_uint4(0, 0, 0, 0);
      }
#pragma unroll
      for (int q = 0; q < 4; ++q) {
        const uint32_t w0 = (&rows[0].x)[q], w1 = (&rows[1].x)[q];
        const uint32_t w2 = (&rows[2].x)[q], w3 = (&rows[3].x)[q];
        const uint32_t lo01 = __byte_perm(w0, w1, 0x5140), hi01 = __byte_perm(w0, w1, 0x7362);
        const uint32_t lo23 = __byte_perm(w2, w3, 0x5140), hi23 = __byte_perm(w2, w3, 0x7362);
        unsigned char* dst = sb + (nn + 4 * q) * ROW + kq;
        *reinterpret_cast<uint32_t*>(dst) = __byte_perm(lo01, lo23, 0x5410);
        *reinterpret_cast<uint32_t*>(dst + ROW) = __byte_perm(lo01, lo23, 0x7632);
        *reinterpret_cast<uint32_t*>(dst + 2 * ROW) = __byte_perm(hi01, hi23, 0x5410);
        *reinterpret_cast<uint32_t*>(dst + 3 * ROW) = __byte_perm(hi01, hi23, 0x7632);
      }
    } else {
#pragma unroll 4
      for (int q = 0; q < BN * KC / 4 / DOT_THREADS; ++q) {
        const int p = tid + q * DOT_THREADS;
        const int nn = p % BN, kq = (p / BN) * 4;
        uint32_t w = 0;
        if (n0 + nn < n) {
#pragma unroll
          for (int j = 0; j < 4; ++j)
            if (k0 + kq + j < k)
              w |= (uint32_t)(uint8_t)__ldg(b + (size_t)(k0 + kq + j) * n + n0 + nn) << (8 * j);
        }
        *reinterpret_cast<uint32_t*>(sb + nn * ROW + kq) = w;
      }
    }
    __syncthreads();
#pragma unroll
    for (int kk = 0; kk < KC / 32; ++kk)
#pragma unroll
      for (int np = 0; np < 2; ++np) {
        uint32_t r[4];
        ldmatrix_x4(r, sb + (wn * 32 + np * 16 + (lane & 7) + (lane >> 4) * 8) * ROW +
                           kk * 32 + ((lane >> 3) & 1) * 16);
        bf[kk][2 * np][0] = r[0];
        bf[kk][2 * np][1] = r[1];
        bf[kk][2 * np + 1][0] = r[2];
        bf[kk][2 * np + 1][1] = r[3];
      }
    b_key = key;
  };

  // A's first chunks in flight while the first B chunk is staged.
#pragma unroll
  for (int p = 0; p < STAGES - 1; ++p) load_a(p);
  if (steps > 0) load_b(((int)blockIdx.x / mt) * nk);

  for (int s = 0; s < steps; ++s) {
    cp_async_wait<STAGES - 2>();
    __syncthreads();  // step s's chunk landed for all; stage (s - 1) % STAGES is free
    load_a(s + STAGES - 1);
    const int u = blockIdx.x + (s / nk) * gridDim.x, kc = s % nk;
    const int m0 = (u % mt) * BM, n0 = (u / mt) * BN;
    const int key = (u / mt) * nk + kc;
    if (key != b_key) load_b(key);  // the same for every thread of the CTA

    if (kc == 0) {
#pragma unroll
      for (int mi = 0; mi < 2; ++mi)
#pragma unroll
        for (int ni = 0; ni < 4; ++ni)
#pragma unroll
          for (int q = 0; q < 4; ++q) acc[mi][ni][q] = 0;
    }
    const unsigned char* st = sa + (s % STAGES) * A_BYTES;
#pragma unroll
    for (int kk = 0; kk < KC / 32; ++kk) {
      uint32_t af[2][4];
#pragma unroll
      for (int mi = 0; mi < 2; ++mi)
        ldmatrix_x4(af[mi], st + (wm * 32 + mi * 16 + (lane & 7) + ((lane >> 3) & 1) * 8) * ROW +
                                kk * 32 + (lane >> 4) * 16);
#pragma unroll
      for (int mi = 0; mi < 2; ++mi)
#pragma unroll
        for (int ni = 0; ni < 4; ++ni) mma_s8(acc[mi][ni], af[mi], bf[kk][ni]);
    }

    if (kc == nk - 1) {
      // Fragments (row g / g + 8, columns 2t, 2t + 1 of each 16 x 8) to the
      // warp's [32][CST] tile, then out as 16-byte pieces of 128-byte rows.
#pragma unroll
      for (int mi = 0; mi < 2; ++mi)
#pragma unroll
        for (int ni = 0; ni < 4; ++ni) {
          const int r = mi * 16 + g, col = ni * 8 + 2 * t;
          *reinterpret_cast<int2*>(sc + r * CST + col) = make_int2(acc[mi][ni][0], acc[mi][ni][1]);
          *reinterpret_cast<int2*>(sc + (r + 8) * CST + col) =
              make_int2(acc[mi][ni][2], acc[mi][ni][3]);
        }
      __syncwarp();
      const int col = (lane & 7) * 4, gc = n0 + wn * 32 + col;
#pragma unroll
      for (int it = 0; it < 8; ++it) {
        const int r = it * 4 + (lane >> 3), gr = m0 + wm * 32 + r;
        if (gr < m) {
          int32_t* dst = out + (size_t)gr * n + gc;
          const int32_t* src = sc + r * CST + col;
          if constexpr (kVecOut) {
            if (gc < n)  // evict-first: up to 5% faster than plain stores at the zig-zag
                         // shape (tools/bench_probe.py, NVIDIA H100 80GB HBM3, 700.00 W)
              __stcs(reinterpret_cast<int4*>(dst), *reinterpret_cast<const int4*>(src));
          } else {
#pragma unroll
            for (int j = 0; j < 4; ++j)
              if (gc + j < n) dst[j] = src[j];
          }
        }
      }
      __syncwarp();
    }
  }
  cp_async_wait<0>();
}

template <bool kVecA, bool kVecOut>
int launch_dot(const int8_t* a, const int8_t* b, int32_t* out, int m, int k, int n,
               cudaStream_t stream) {
  auto kernel = probe_dot_i8_kernel<kVecA, kVecOut>;
  static bool ready[kMaxDevices];
  static int resident = 0;
  int dev = 0;
  cudaGetDevice(&dev);
  if (dev >= kMaxDevices || !ready[dev]) {
    cudaError_t e = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                                         DOT_SMEM);
    if (e != cudaSuccess) return (int)e;
    if (!resident)
      cudaOccupancyMaxActiveBlocksPerMultiprocessor(&resident, kernel, DOT_THREADS, DOT_SMEM);
    if (dev < kMaxDevices) ready[dev] = true;
  }
  const long long units = (long long)((m + BM - 1) / BM) * ((n + BN - 1) / BN);
  long long grid = (long long)sm_count() * (resident > 0 ? resident : 1);
  if (grid > units) grid = units;
  const bool vec_b = (reinterpret_cast<uintptr_t>(b) & 15) == 0 && n % 16 == 0;
  kernel<<<(int)grid, DOT_THREADS, DOT_SMEM, stream>>>(a, b, out, m, k, n, vec_b);
  return (int)cudaGetLastError();
}

}  // namespace

extern "C" int probe_elementwise(const float* a, const float* b, const float* c,
                                 float* out, int n, int op, void* stream) {
  if (n <= 0) return 0;
  cudaStream_t s = (cudaStream_t)stream;
  switch (op) {
    case OP_EXP2: return launch_elementwise<OP_EXP2>(a, b, c, out, n, s);
    case OP_LOG2: return launch_elementwise<OP_LOG2>(a, b, c, out, n, s);
    case OP_SQRT: return launch_elementwise<OP_SQRT>(a, b, c, out, n, s);
    case OP_RSQRT: return launch_elementwise<OP_RSQRT>(a, b, c, out, n, s);
    case OP_DIV: return launch_elementwise<OP_DIV>(a, b, c, out, n, s);
    case OP_RECIP: return launch_elementwise<OP_RECIP>(a, b, c, out, n, s);
    case OP_MUL_ADD: return launch_elementwise<OP_MUL_ADD>(a, b, c, out, n, s);
    case OP_CBRT: return launch_elementwise<OP_CBRT>(a, b, c, out, n, s);
    case OP_AQ_TAIL: return launch_elementwise<OP_AQ_TAIL>(a, b, c, out, n, s);
    case OP_EXP: return launch_elementwise<OP_EXP>(a, b, c, out, n, s);
    case OP_LOG: return launch_elementwise<OP_LOG>(a, b, c, out, n, s);
    default: return (int)cudaErrorInvalidValue;
  }
}

extern "C" int probe_dot_i8(const int8_t* a, const int8_t* b, int32_t* out, int m, int k,
                            int n, void* stream) {
  if (m <= 0 || k <= 0 || n <= 0) return (int)cudaErrorInvalidValue;
  cudaStream_t s = (cudaStream_t)stream;
  const bool vec_a = (reinterpret_cast<uintptr_t>(a) & 15) == 0 && k % 16 == 0;
  const bool vec_out = (reinterpret_cast<uintptr_t>(out) & 15) == 0 && n % 4 == 0;
  if (vec_a)
    return vec_out ? launch_dot<true, true>(a, b, out, m, k, n, s)
                   : launch_dot<true, false>(a, b, out, m, k, n, s);
  return vec_out ? launch_dot<false, true>(a, b, out, m, k, n, s)
                 : launch_dot<false, false>(a, b, out, m, k, n, s);
}
