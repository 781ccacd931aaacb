// The exactness probe's two kernels (jxl_tiny_tpu_torch/tools/
// probe_op_exactness.py): how the card's compiled float ops round, against
// torch on the same device and against the float64 reference.
//
// probe_elementwise replaces tools/probe_op_exactness.py:pallas_elementwise
// (its pl.pallas_call at :36): one float op applied elementwise in a trivial
// kernel, so that the op is compiled by the kernel compiler (here nvcc, at
// the flags the library was built with) rather than by the framework. One
// thread per element; `op` picks the operation (the codes of
// ops/probe_kernels.OPS); float32 in and out. Plain torch version:
// ops/probe_kernels.probe_elementwise_plain (the same op in torch on the same
// device). Built with the port's NVCC_FLAGS (-fmad=false -prec-div=true
// -prec-sqrt=true) the correctly rounded ops (div, sqrt, recip, and a*b+c as
// two roundings) equal torch's bit for bit; the others (exp2, log2, rsqrt,
// cbrt, exp, log) are the CUDA math library's and their distance is a
// measurement.
// Bound on the H100: bytes (each input read once, the output written once);
// the probe's 2^19 values take ~2-3 us of bytes, below a launch's own cost.
//
// probe_dot_i8 replaces tools/probe_op_exactness.py:kern_i8 (its
// pl.pallas_call at :152): an int8 [M, K] x [K, N] product with int32
// accumulation (the probe's one-hot permutation dot, [256,128] x [128,128]).
// One thread per output element walks K in order; integer sums are exact, so
// the plain version (ops/probe_kernels.probe_dot_i8_plain, the int32 product
// in torch) must equal it exactly. Bound: bytes (~0.1 MB at the probe's
// shape); the 4.2 M multiply-adds take ~2 ns at int8 tensor-core rate. A
// tensor-core kernel would gain nothing at this size: the launch dominates.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

enum Op {
  OP_EXP2 = 0, OP_LOG2, OP_SQRT, OP_RSQRT, OP_DIV, OP_RECIP, OP_MUL_ADD,
  OP_CBRT, OP_AQ_TAIL, OP_EXP, OP_LOG,
};

__global__ void probe_elementwise_kernel(const float* __restrict__ a,
                                         const float* __restrict__ b,
                                         const float* __restrict__ c,
                                         float* __restrict__ out, int n, int op) {
  int i = blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= n) return;
  float x = a[i];
  float r;
  switch (op) {
    case OP_EXP2: r = exp2f(x); break;
    case OP_LOG2: r = log2f(x); break;
    case OP_SQRT: r = sqrtf(x); break;
    case OP_RSQRT: r = rsqrtf(x); break;
    case OP_DIV: r = x / b[i]; break;
    case OP_RECIP: r = 1.0f / x; break;
    case OP_MUL_ADD: r = x * b[i] + c[i]; break;
    case OP_CBRT: r = cbrtf(x); break;
    // The AQ field's tail as the kernels write it: exp2(v * log2e) * m + a.
    case OP_AQ_TAIL: r = exp2f(x * 1.442695041f) * 0.7f + 0.1f; break;
    case OP_EXP: r = expf(x); break;
    case OP_LOG: r = logf(x); break;
    default: r = __int_as_float(0x7fc00000); break;
  }
  out[i] = r;
}

__global__ void probe_dot_i8_kernel(const int8_t* __restrict__ a,
                                    const int8_t* __restrict__ b,
                                    int32_t* __restrict__ out, int m, int k, int n) {
  int col = blockIdx.x * blockDim.x + threadIdx.x;
  int row = blockIdx.y;
  if (col >= n || row >= m) return;
  const int8_t* ar = a + (size_t)row * k;
  int32_t acc = 0;
  for (int t = 0; t < k; ++t)
    acc += (int32_t)ar[t] * (int32_t)__ldg(b + (size_t)t * n + col);
  out[(size_t)row * n + col] = acc;
}

}  // namespace

extern "C" int probe_elementwise(const float* a, const float* b, const float* c,
                                 float* out, int n, int op, void* stream) {
  if (n > 0)
    probe_elementwise_kernel<<<(n + 255) / 256, 256, 0, (cudaStream_t)stream>>>(
        a, b, c, out, n, op);
  return (int)cudaGetLastError();
}

extern "C" int probe_dot_i8(const int8_t* a, const int8_t* b, int32_t* out,
                            int m, int k, int n, void* stream) {
  if (m > 0 && n > 0)
    probe_dot_i8_kernel<<<dim3((n + 127) / 128, m), 128, 0, (cudaStream_t)stream>>>(
        a, b, out, m, k, n);
  return (int)cudaGetLastError();
}
