// Stream compaction and section copy, both driven by the output.
//
// compact_rows replaces two Pallas TPU kernels with one output contract:
// jxl_tiny_tpu/ops/pack_kernels.py:_compact_kernel (compact_stream) and
// :_compact_hier_kernel (compact_stream_hier). Each row r of a group holds
// cnt[r] valid leading lanes; they land at stream[start[r] + lane], where
// start is the exclusive prefix sum of the counts (taken by torch.cumsum
// before the launch). The row ranges tile [0, total) exactly, so position
// p < min(total, cap) holds lane p - start[r] of the last row r with
// start[r] <= p, and the rest of the [cap + 128] row is zero; positions
// >= cap are dropped (callers re-run an over-cap group at a larger cap,
// its total being exact either way). The TPU needed a row-merge
// preconditioner and rolled, 128-lane-aligned OR-placement because its
// vector stores must be aligned; here the rows are read straight from the
// [G, R, 128] tokenizer layout.
// Plain torch version: ops/pack_kernels.py:compact_rows_plain.
//
// Bound on the H100: bytes (the counted tokens read once, every output word
// written once, the starts read once). What kept a row-driven kernel far
// from that bound was latency, not bytes: the typical row holds ~4 tokens
// and half the rows none, so a warp per row idles 28 of 32 lanes and walks
// a dependent cnt -> start -> token -> store chain per row. So the work is
// cut by output position, which is the same for every thread whatever the
// row lengths: a CTA of 128 threads owns 1024 consecutive positions of one
// group, a thread two 16-byte vectors of them. 64 strided samples of the
// group's starts (one round trip, counted by __syncthreads_count) bracket
// the rows the tile spans; exactly those rows' starts are staged in shared
// memory with coalesced loads (in chunks of 4096 rows: runs of empty rows
// make the span unbounded); each thread finds the rows of its eight
// positions there by eight binary searches run in lockstep (independent
// chains, the same step count for every thread), gathers its tokens with
// independent 4-byte streaming loads of the rows' leading lanes (a row is
// read once and never again, so it should not push the starts and the
// output out of L2), and writes 16-byte vectors. Zero positions come out
// of the same store, so every output word is written once, coalesced; a
// tile past min(total, cap) skips the search.
//
// copy_sections replaces jxl_tiny_tpu/ops/pack_kernels.py:_sections_kernel
// (compact_sections): each group's ceil(bits / 4096) 128-word blocks are
// copied to a 128-word-aligned offset of one [wcap] buffer (offs is the
// exclusive prefix sum of the block counts) and the rest of the buffer is
// zeroed. Plain torch version: ops/pack_kernels.py:copy_sections_plain.
//
// Bound: bytes, and ~95% of them are the zero fill, so the whole card has
// to take part in it. A grid sized to the card (4 CTAs of 256 threads a
// multiprocessor) strides over the 128-word output blocks, a warp per
// block (32 lanes x 16 bytes); offsets and block counts sit in shared
// memory; a block below the end of the last section finds its group by
// binary search and copies 16-byte vectors from the group's row (or is
// zero where the row has no such block), a block past it is zero. Each
// output word is written once.

#include <cuda_runtime.h>

namespace {

// jxl_tiny_tpu_torch/tools/bench_compact.py builds variants of this file
// with other values of these constants.
constexpr int W = 128;
constexpr int THREADS = 128;             // compact_rows: threads of a CTA
constexpr int NV = 2;                    // 16-byte vectors a thread writes
constexpr int TILE = THREADS * 4 * NV;   // output positions a CTA owns
constexpr int CH = 4096;                 // rows whose starts are staged at a time
constexpr int SAMPLES = 64;              // starts sampled to bracket a tile's rows
constexpr bool STREAM_TOKENS = true;     // read tokens with evict-first loads
constexpr int FAR = 1 << 30;             // a start beyond every tile
constexpr int COPY_THREADS = 256;        // copy_sections: threads of a CTA
constexpr int COPY_CTAS_PER_SM = 4;      // its grid, per multiprocessor
constexpr int MAXG = 512;                // groups whose offsets fit shared memory
static_assert(SAMPLES <= THREADS && TILE % W == 0, "compact_rows tiling");

// First index in [lo, hi) whose value is > q (a is non-decreasing).
template <typename T>
__device__ __forceinline__ int upper_bound(const T* a, int lo, int hi, T q) {
  while (lo < hi) {
    const int mid = (lo + hi) >> 1;
    if (a[mid] <= q) lo = mid + 1; else hi = mid;
  }
  return lo;
}

__global__ void __launch_bounds__(THREADS)
compact_rows_kernel(const int* __restrict__ tok, const int* __restrict__ cnt,
                    const long long* __restrict__ start, int* __restrict__ stream,
                    int rows, int cap, int tiles) {
  __shared__ int rel[CH + 1];  // starts of the staged rows, relative to the tile
  const int t = threadIdx.x;
  const int g = blockIdx.x / tiles, tile = blockIdx.x - g * tiles;
  const long long row_len = (long long)cap + W;
  const size_t gr = (size_t)g * rows;
  const long long* st = start + gr;
  const int* src = tok + gr * W;
  const long long tile_lo = (long long)tile * TILE;
  const int tile_len = (int)min((long long)TILE, row_len - tile_lo);
  // The first SAMPLES threads sample the starts, every `stride` rows.
  const int stride = (rows + SAMPLES - 1) / SAMPLES;
  const int rs = t * stride;
  const long long sample = (t < SAMPLES && rs < rows) ? st[rs] : (long long)FAR * FAR;
  const long long total = st[rows - 1] + cnt[gr + rows - 1];
  const long long lim = min(total, (long long)cap);
  // Positions of this tile that hold tokens (the same for the whole CTA).
  const int need = (int)min((long long)tile_len, lim - tile_lo);
  // Vector j of thread t covers positions (j * THREADS + t) * 4 .. + 3.
  int4 v[NV];
#pragma unroll
  for (int j = 0; j < NV; ++j) v[j] = make_int4(0, 0, 0, 0);
  if (need > 0) {
    // Rows [rb, re) cover the tile's tokens: start[rb] <= tile_lo, and
    // start[re] lies past the last needed position (or re == rows).
    const int n_lo = __syncthreads_count(sample <= tile_lo);
    const int n_hi = __syncthreads_count(sample <= tile_lo + need - 1);
    const int rb = max(n_lo - 1, 0) * stride;
    const int re = min(n_hi * stride, rows);
    for (int base = rb; base < re; base += CH) {
      const int n = min(CH, re - base);  // rows staged: rel[0..n), rel[n] ends them
      if (base != rb) __syncthreads();
      for (int i = t; i <= n; i += THREADS) {
        const int r = base + i;
        long long d = FAR;
        if (r < re) d = max(min(st[r] - tile_lo, (long long)FAR), -(long long)FAR);
        rel[i] = (int)d;
      }
      __syncthreads();
      // u = how many of rel[0..n] are <= q, found for all of a thread's
      // positions in lockstep (independent chains, the same step count for
      // every thread). 1 <= u <= n: q lies in row base + u - 1; u == 0: an
      // earlier chunk had it; u > n: a later one has.
      const int top = 1 << (31 - __clz(n + 1));
      int u[NV][4];
#pragma unroll
      for (int j = 0; j < NV; ++j)
#pragma unroll
        for (int k = 0; k < 4; ++k) u[j][k] = 0;
      for (int step = top; step > 0; step >>= 1) {
#pragma unroll
        for (int j = 0; j < NV; ++j)
#pragma unroll
          for (int k = 0; k < 4; ++k) {
            const int c = u[j][k] + step;
            if (c <= n + 1 && rel[c - 1] <= (j * THREADS + t) * 4 + k) u[j][k] = c;
          }
      }
#pragma unroll
      for (int j = 0; j < NV; ++j) {
        int* vj = reinterpret_cast<int*>(&v[j]);
#pragma unroll
        for (int k = 0; k < 4; ++k) {
          const int q = (j * THREADS + t) * 4 + k, uk = u[j][k];
          if (q < need && uk >= 1 && uk <= n) {
            const int* p = src + (size_t)(base + uk - 1) * W + ((q - rel[uk - 1]) & (W - 1));
            vj[k] = STREAM_TOKENS ? __ldcs(p) : *p;
          }
        }
      }
    }
  }
  int4* out = reinterpret_cast<int4*>(stream + (size_t)g * row_len + tile_lo);
#pragma unroll
  for (int j = 0; j < NV; ++j)
    if ((j * THREADS + t) * 4 < tile_len) out[j * THREADS + t] = v[j];
}

__global__ void __launch_bounds__(COPY_THREADS)
copy_sections_kernel(const int* __restrict__ packed, const long long* __restrict__ nblk,
                     const long long* __restrict__ offs, int* __restrict__ buf,
                     int groups, int ow, long long nout) {
  __shared__ long long s_off[MAXG], s_nb[MAXG];
  const int t = threadIdx.x, warp = t >> 5, lane = t & 31;
  const long long* po = offs;
  const long long* pn = nblk;
  // Offsets are 64-bit and groups an int: any group count; up to MAXG
  // groups the offsets are read from shared memory, beyond from global.
  if (groups <= MAXG) {
    for (int i = t; i < groups; i += COPY_THREADS) {
      s_off[i] = offs[i];
      s_nb[i] = nblk[i];
    }
    __syncthreads();
    po = s_off;
    pn = s_nb;
  }
  const long long used = po[groups - 1] + pn[groups - 1] * W;  // end of the last section
  constexpr int WARPS = COPY_THREADS / 32;
  for (long long b = (long long)blockIdx.x * WARPS + warp; b < nout;
       b += (long long)gridDim.x * WARPS) {
    const long long p = b * W;
    int4 v = make_int4(0, 0, 0, 0);
    if (p < used) {
      // The last group whose offset is <= p owns this block, if it has
      // that many blocks and its [ow] row holds the block.
      const int g = upper_bound(po, 0, groups, p) - 1;
      if (g >= 0) {
        const long long i = (p - po[g]) / W;
        if (i < pn[g] && (i + 1) * W <= ow)
          v = reinterpret_cast<const int4*>(packed + (size_t)g * ow + i * W)[lane];
      }
    }
    reinterpret_cast<int4*>(buf + p)[lane] = v;
  }
}

}  // namespace

extern "C" int compact_rows_launch(const int* tok, const int* cnt,
                                   const long long* start, int* stream,
                                   int groups, int rows, int cap, void* stream_h) {
  if (groups > 0 && rows > 0) {
    // An int grid of groups * tiles CTAs: up to 65,075,262 groups at cap
    // 32768 (33 tiles), 8,355,967 at cap 262144; starts and stream offsets
    // are 64-bit.
    const int tiles = (int)(((long long)cap + W + TILE - 1) / TILE);
    compact_rows_kernel<<<groups * tiles, THREADS, 0, (cudaStream_t)stream_h>>>(
        tok, cnt, start, stream, rows, cap, tiles);
  }
  return (int)cudaGetLastError();
}

extern "C" int copy_sections_launch(const int* packed, const long long* nblk,
                                    const long long* offs, int* buf, int groups,
                                    int ow, int wcap, void* stream_h) {
  if (groups > 0 && wcap > 0) {
    int dev = 0, sms = 0;
    cudaGetDevice(&dev);
    cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
    const long long nout = wcap / W;
    const long long want = (nout + COPY_THREADS / 32 - 1) / (COPY_THREADS / 32);
    const long long most = (long long)(sms > 0 ? sms : 1) * COPY_CTAS_PER_SM;
    const int grid = (int)(want < most ? want : most);
    copy_sections_kernel<<<grid, COPY_THREADS, 0, (cudaStream_t)stream_h>>>(
        packed, nblk, offs, buf, groups, ow, nout);
  }
  return (int)cudaGetLastError();
}
