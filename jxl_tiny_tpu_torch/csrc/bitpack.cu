// Token bit packer: a CTA per chunk of a group's tokens, a thread per run of
// consecutive tokens, every output word stored once.
//
// Replaces the Pallas TPU kernel jxl_tiny_tpu/ops/pack_kernels.py:
// _bitpack_var_kernel (reached through bitpack_groups_var). Plain torch
// version: jxl_tiny_tpu_torch/ops/pack_kernels.py:bitpack_groups_var_plain.
//
// Each token is an LSB-first bit pattern of nbits <= 28 bits at bit
// position pos of its group's section; the section's words are the OR of all
// tokens, zero beyond the last token, and words at or beyond `ow` are
// dropped. Contract, as the JAX packer's (its fused entries read one
// position each): inside a group, pos is the exclusive prefix sum of nbits,
// so pos[0] = 0 and the section is `total` = pos[cap-1] + nbits[cap-1] bits.
// Tokens of width 0 may sit anywhere (the DC layout's padding); they are
// no-ops.
//
// Bound on the H100: memory, and little of it. Fields are int32 (the JAX
// function's types). A chunk whose first and next chunk's positions are
// equal holds no bits, so it reads none of its tokens; past the section's
// end the function needs only the zero words. Word ownership makes every
// store plain: word k belongs to the chunk whose bit range [c0, c1) holds
// its first bit 32k.
//   - A thread loads its RUN tokens' data and widths (16-byte loads where
//     the rows allow) and its run's first position, then merges the run into
//     words with a 64-bit accumulator. A word wholly inside the run is stored
//     to the CTA's word buffer in shared memory; the run's first word (when
//     the run starts inside it) and its last partial word, which neighbouring
//     runs share, are ORed in with shared-memory atomics.
//   - The chunk's last word reaches up to 31 bits into the next chunk: warp
//     0 reads the next 32 tokens and ORs their parts in; where zero widths
//     leave bits of the word still missing, each lane binary-searches the
//     positions for the token that starts at one of them.
//   - After one barrier the CTA stores its owned words [ceil(c0/32),
//     ceil(c1/32)) to the output, coalesced. The words from the section's
//     end to ow are zero, spread evenly over the group's chunks, so no
//     memset runs before the kernel and no word is written twice.
// OR is exact in any order, so the words equal the plain version's bit for
// bit. The TPU kernel's scalar loop made per-entry cost the limit, hence its
// fan-32 merge tree, front-sorted index lists, chunking and the entry clamp
// near the end of the row; none of that is needed here.

#include <cuda_runtime.h>

#include <cstdint>

namespace {

constexpr int THREADS = 128;          // threads a CTA
constexpr int RUN = 8;                // consecutive tokens a thread (a multiple of 4)
constexpr int CHUNK = THREADS * RUN;  // tokens a CTA
constexpr int BUF = CHUNK + 2;        // words of a chunk's bits at <= 32 bits a token
constexpr unsigned FULL = 0xffffffffu;

// RUN consecutive values of one row from token t on; zero beyond cap.
// VEC: 16-byte loads (cap % 4 == 0 and 16-byte aligned rows).
template <bool VEC>
__device__ __forceinline__ void load_run(const int* __restrict__ a, int t, int cap,
                                         int (&v)[RUN]) {
#pragma unroll
  for (int j = 0; j < RUN; j += 4) {
    if (VEC) {
      const int4 x = t + j < cap ? __ldg(reinterpret_cast<const int4*>(a + t + j))
                                 : make_int4(0, 0, 0, 0);
      v[j] = x.x; v[j + 1] = x.y; v[j + 2] = x.z; v[j + 3] = x.w;
    } else {
#pragma unroll
      for (int i = j; i < j + 4; ++i) v[i] = t + i < cap ? __ldg(a + t + i) : 0;
    }
  }
}

template <bool VEC>
__global__ void __launch_bounds__(THREADS)
bitpack_kernel(const int* __restrict__ data, const int* __restrict__ nbits,
               const int* __restrict__ pos, unsigned* __restrict__ out, int cap,
               int ow, int chunks) {
  __shared__ unsigned words[BUF];
  const int chunk = blockIdx.x;
  const size_t row = (size_t)blockIdx.y * cap;
  data += row;
  nbits += row;
  pos += row;
  unsigned* orow = out + (size_t)blockIdx.y * ow;
  const int t0 = chunk * CHUNK;
  const int total = __ldg(pos + cap - 1) + __ldg(nbits + cap - 1);
  const int c0 = __ldg(pos + t0);
  const int c1 = t0 + CHUNK < cap ? __ldg(pos + t0 + CHUNK) : total;

  // This chunk's share of the zero words from the section's end to ow.
  const int wt = min((total + 31) >> 5, ow);
  const int zshare = (ow - wt + chunks - 1) / chunks;
  const int z1 = min(wt + (chunk + 1) * zshare, ow);
  for (int k = wt + chunk * zshare + threadIdx.x; k < z1; k += THREADS) orow[k] = 0u;
  if (c1 == c0) return;  // no bits: every width in the chunk is 0

  const int t = t0 + threadIdx.x * RUN;
  int d[RUN], n[RUN];
  load_run<VEC>(data, t, cap, d);
  load_run<VEC>(nbits, t, cap, n);
  const int p0 = t < cap ? __ldg(pos + t) : total;
  for (int i = threadIdx.x; i < BUF; i += THREADS) words[i] = 0u;
  __syncthreads();

  // Merge the run into words; buffer word 0 is output word c0 >> 5.
  const int kb = c0 >> 5;
  const int kfirst = (p0 >> 5) - kb;
  const bool left_shared = (p0 & 31) != 0;
  unsigned long long acc = 0;
  int fill = p0 & 31, k = kfirst;
#pragma unroll
  for (int i = 0; i < RUN; ++i) {
    const int nb = n[i] > 0 ? n[i] : 0;
    acc |= (unsigned long long)(nb > 0 ? (unsigned)d[i] : 0u) << fill;
    fill += nb;
    if (fill >= 32) {
      if ((unsigned)k < (unsigned)BUF) {
        if (left_shared && k == kfirst) atomicOr(&words[k], (unsigned)acc);
        else words[k] = (unsigned)acc;
      }
      acc >>= 32;
      fill -= 32;
      ++k;
    }
  }
  if (fill > 0 && (unsigned)acc != 0u && (unsigned)k < (unsigned)BUF)
    atomicOr(&words[k], (unsigned)acc);

  // The chunk's last word, when it starts inside the chunk and later tokens
  // continue it: the next 32 tokens, and if their bits do not reach the
  // word's end (zero widths may interleave), each lane finds the token that
  // starts at one of the missing bits by binary search over the positions.
  const int ws = c1 & ~31;
  if (threadIdx.x < 32 && (c1 & 31) != 0 && ws >= c0 && c1 < total) {
    const int lane = threadIdx.x, we = ws + 32, j = t0 + CHUNK + lane;
    int end = total;
    unsigned part = 0u;
    if (j < cap) {
      const int pj = __ldg(pos + j), nb = __ldg(nbits + j);
      end = pj + (nb > 0 ? nb : 0);
      if (nb > 0 && pj < we) part = (unsigned)__ldg(data + j) << (pj - ws);
    }
    const int reached = __shfl_sync(FULL, end, 31);  // bits before it are done
    const int b = reached + lane;
    if (b < we && b < total) {
      int lo = t0 + CHUNK + 32, hi = cap - 1;  // the last token at or before b
      while (lo < hi) {
        const int mid = (lo + hi + 1) >> 1;
        if (__ldg(pos + mid) <= b) lo = mid;
        else hi = mid - 1;
      }
      if (__ldg(pos + lo) == b) part |= (unsigned)__ldg(data + lo) << (b - ws);
    }
    const unsigned w = __reduce_or_sync(FULL, part);
    if (lane == 0) atomicOr(&words[(c1 >> 5) - kb], w);
  }
  __syncthreads();

  const int own1 = min((c1 + 31) >> 5, ow);
  for (int q = ((c0 + 31) >> 5) + threadIdx.x; q < own1; q += THREADS) orow[q] = words[q - kb];
}

}  // namespace

extern "C" int bitpack_launch(const int* data, const int* nbits, const int* pos,
                              unsigned* out, int groups, int cap, int ow,
                              void* stream_h) {
  if (groups <= 0 || ow <= 0) return (int)cudaGetLastError();
  cudaStream_t stream = (cudaStream_t)stream_h;
  if (cap <= 0) {
    const cudaError_t rc =
        cudaMemsetAsync(out, 0, (size_t)groups * ow * sizeof(unsigned), stream);
    return rc != cudaSuccess ? (int)rc : (int)cudaGetLastError();
  }
  const int chunks = (cap + CHUNK - 1) / CHUNK;
  // One grid row a group: up to 65,535 groups (the grid's y limit).
  const dim3 grid(chunks, groups);
  const bool vec = cap % 4 == 0 && (uintptr_t)data % 16 == 0 && (uintptr_t)nbits % 16 == 0;
  if (vec) {
    bitpack_kernel<true><<<grid, THREADS, 0, stream>>>(data, nbits, pos, out, cap, ow, chunks);
  } else {
    bitpack_kernel<false><<<grid, THREADS, 0, stream>>>(data, nbits, pos, out, cap, ow, chunks);
  }
  return (int)cudaGetLastError();
}
