// Stream compaction and section copy.
//
// compact_rows replaces two Pallas TPU kernels with one output contract:
// jxl_tiny_tpu/ops/pack_kernels.py:_compact_kernel (compact_stream) and
// :_compact_hier_kernel (compact_stream_hier). Each row r of a group holds
// cnt[r] valid leading lanes; they land at stream[start[r] + lane], where
// start is the exclusive prefix sum of the counts (taken by torch.cumsum
// before the launch). The row ranges tile [0, total) exactly, so every
// position below min(total, cap) is written once by a token and the rest
// of the [cap + 128] row is zero-filled; positions >= cap are dropped
// (callers re-run an over-cap group at a larger cap, its total being
// exact either way). The TPU needed a row-merge preconditioner and rolled,
// 128-lane-aligned OR-placement because its vector stores must be
// aligned; a GPU thread simply stores each token at its own address, so
// the rows are read straight from the [G, 3072, 128] tokenizer layout.
// Plain torch version: ops/pack_kernels.py:compact_rows_plain.
//
// Bound on the H100: memory. The useful bytes are the counted tokens (read
// once, written once) plus the zero tail; a row's 128 lanes are read by
// one warp, 16 B a thread would overfetch, so each thread reads single
// words of the row's leading lanes only.
//
// copy_sections replaces jxl_tiny_tpu/ops/pack_kernels.py:_sections_kernel
// (compact_sections): each group's ceil(bits / 4096) 128-word blocks are
// copied to a 128-word-aligned offset of one [wcap] buffer and the rest of
// the buffer is zeroed. A grid over groups x 128-word blocks, one thread
// per word; a copy, so memory-bound on the section bytes.
// Plain torch version: ops/pack_kernels.py:copy_sections_plain.

#include <cuda_runtime.h>

namespace {

constexpr int W = 128;
constexpr int ROWS_PER_CTA = 64;
constexpr int THREADS = 256;

__global__ void __launch_bounds__(THREADS)
compact_rows_kernel(const int* __restrict__ tok, const int* __restrict__ cnt,
                    const long long* __restrict__ start, int* __restrict__ stream,
                    int rows, int cap) {
  const int g = blockIdx.x;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const long long row_len = (long long)cap + W;
  int* out = stream + (size_t)g * row_len;
  const size_t gr = (size_t)g * rows;
  const int r0 = blockIdx.y * ROWS_PER_CTA;
  const int r1 = min(r0 + ROWS_PER_CTA, rows);
  for (int r = r0 + warp; r < r1; r += THREADS / 32) {
    const int c = cnt[gr + r];
    const long long s = start[gr + r];
    const int* src = tok + (gr + r) * W;
    for (int l = lane; l < c; l += 32) {
      const long long p = s + l;
      if (p < cap) out[p] = src[l];
    }
  }
  // Zero tail [min(total, cap), cap + 128), shared by the group's CTAs.
  const long long total = start[gr + rows - 1] + cnt[gr + rows - 1];
  const long long lo = total < cap ? total : cap;
  const long long step = (long long)gridDim.y * THREADS;
  for (long long p = lo + (long long)blockIdx.y * THREADS + threadIdx.x;
       p < row_len; p += step)
    out[p] = 0;
}

__global__ void __launch_bounds__(W)
copy_sections_kernel(const int* __restrict__ packed, const long long* __restrict__ nblk,
                     const long long* __restrict__ offs, int* __restrict__ buf,
                     int groups, int ow, int wcap) {
  const int g = blockIdx.x, i = blockIdx.y, t = threadIdx.x;
  if (g == groups) {
    // Zero everything after the last section.
    const long long used = offs[groups - 1] + nblk[groups - 1] * W;
    for (long long p = used + (long long)i * W + t; p < wcap;
         p += (long long)gridDim.y * W)
      buf[p] = 0;
    return;
  }
  if (i >= nblk[g]) return;
  const long long dst = offs[g] + (long long)i * W + t;
  const int src = i * W + t;
  if (dst < wcap) buf[dst] = src < ow ? packed[(size_t)g * ow + src] : 0;
}

}  // namespace

extern "C" int compact_rows_launch(const int* tok, const int* cnt,
                                   const long long* start, int* stream,
                                   int groups, int rows, int cap, void* stream_h) {
  if (groups > 0 && rows > 0) {
    dim3 grid(groups, (rows + ROWS_PER_CTA - 1) / ROWS_PER_CTA);
    compact_rows_kernel<<<grid, THREADS, 0, (cudaStream_t)stream_h>>>(
        tok, cnt, start, stream, rows, cap);
  }
  return (int)cudaGetLastError();
}

extern "C" int copy_sections_launch(const int* packed, const long long* nblk,
                                    const long long* offs, int* buf, int groups,
                                    int ow, int wcap, void* stream_h) {
  if (groups > 0) {
    dim3 grid(groups + 1, (ow + W - 1) / W);
    copy_sections_kernel<<<grid, W, 0, (cudaStream_t)stream_h>>>(
        packed, nblk, offs, buf, groups, ow, wcap);
  }
  return (int)cudaGetLastError();
}
