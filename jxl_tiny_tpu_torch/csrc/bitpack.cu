// Token bit packer: one thread per token, atomicOr into the section words.
//
// Replaces the Pallas TPU kernel jxl_tiny_tpu/ops/pack_kernels.py:
// _bitpack_var_kernel (reached through bitpack_groups_var). Plain torch
// version: jxl_tiny_tpu_torch/ops/pack_kernels.py:bitpack_groups_var_plain.
//
// Each token is an LSB-first bit pattern of nbits <= 28 bits at an absolute
// bit position of its group's section; the section's words are the OR of
// all tokens. A token spans at most two 32-bit words, so a thread shifts
// its token into place and ORs the one or two parts into the output;
// tokens of width 0 do nothing. OR is exact in any order, so the result
// does not depend on the schedule and equals the plain version bit for
// bit. The TPU kernel's scalar loop made per-entry cost the limit, hence
// its fan-32 merge tree, front-sorted index lists, chunking and the entry
// clamp near the end of the row; none of that is needed here. Words at or
// beyond `ow` are dropped.
//
// Bound on the H100: memory. Three fields a token are read once (adjacent
// threads read adjacent tokens) and the [G, ow] words are cleared and
// written; neighbouring tokens hit the same or the next word, so the
// atomics of a warp fall into a few L2 sectors. The fields arrive as int64
// (what token_data_bits produces) although every value fits 32 bits, so
// the kernel reads twice the bytes the function needs.

#include <cuda_runtime.h>

namespace {

constexpr int THREADS = 256;

__global__ void __launch_bounds__(THREADS)
bitpack_kernel(const long long* __restrict__ data, const long long* __restrict__ nbits,
               const long long* __restrict__ pos, unsigned* __restrict__ out,
               int cap, int ow) {
  const int t = blockIdx.x * THREADS + threadIdx.x;
  if (t >= cap) return;
  const size_t i = (size_t)blockIdx.y * cap + t;
  const int nb = (int)nbits[i];
  if (nb <= 0) return;
  const unsigned d = (unsigned)data[i];
  const long long p = pos[i];
  const long long w = p >> 5;
  const int sh = (int)(p & 31);
  unsigned* row = out + (size_t)blockIdx.y * ow;
  if (w < ow) atomicOr(row + w, d << sh);
  if (sh + nb > 32 && w + 1 < ow) atomicOr(row + w + 1, d >> (32 - sh));
}

}  // namespace

extern "C" int bitpack_launch(const long long* data, const long long* nbits,
                              const long long* pos, unsigned* out, int groups,
                              int cap, int ow, void* stream_h) {
  if (groups <= 0 || ow <= 0) return (int)cudaGetLastError();
  cudaStream_t stream = (cudaStream_t)stream_h;
  cudaError_t rc = cudaMemsetAsync(out, 0, (size_t)groups * ow * sizeof(unsigned), stream);
  if (rc != cudaSuccess) return (int)rc;
  if (cap > 0) {
    dim3 grid((cap + THREADS - 1) / THREADS, groups);
    bitpack_kernel<<<grid, THREADS, 0, stream>>>(data, nbits, pos, out, cap, ow);
  }
  return (int)cudaGetLastError();
}
