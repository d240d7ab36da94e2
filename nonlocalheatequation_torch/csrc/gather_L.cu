// The CSR strip gather of the unstructured operator, for NVIDIA Hopper
// (sm_90a).
//
// Replaces the Pallas TPU kernel
//   gather_L <- nonlocalheatequation_tpu/ops/pallas_gather.py:build_gather_L
//               (make_gather_step_fn, the ensemble engine's mesh buckets)
//
// What it computes, over the baked CSR table of ops/gather.py (row i holds
// its neighbours' weights c_i*w_ij, then the centre entry -c_i*wsum_i at
// column i, so the kernel is a pure gather and row sum):
//
//   out[i] = sum_{k in [rowptr[i], rowptr[i+1])} w[k] * u[col[k]]
//
// The bf16 operand tier rounds each gathered value of u once to bfloat16
// before the multiply (through float32, as the JAX package's astype does
// from a float64 carry on the CPU and as the port's other kernels round);
// the weights and the sum stay in the state type.  The TPU kernel pads each
// row to a 128-lane strip; this one reads the rows' entries only.
//
// Design.  One warp per row, eight rows a block.  Lane l sums the row's
// entries l, l+32, ... in order, then one fixed xor-shuffle tree adds the 32
// partial sums: the order is fixed by the row and not by the launch, so
// repeated launches, and the lanes of a stacked ensemble chunk, give the
// same bits as a solo run.
//
// What bounds it on an H100 SXM (published peaks, computed, not measured):
// bytes.  Each baked entry's weight and column are read once (8 bytes in
// f32), the state and the output once: at bench.py's graded 256^2 cloud
// (65,536 nodes, 14.6 M entries with the centres) that is about 117 MB,
// 0.035 ms at 3.35 TB/s.  The gathers of u hit the L2 (the state is 256 KB).
//
// Plain C interface (ops/_build.py, ops/cuda_unstructured.py): launches on
// the given stream, allocates nothing, returns cudaGetLastError() (0 =
// launched), or -1 for an unknown type.

#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include <cstdint>

namespace {

constexpr int THREADS = 256;  // eight warps, one row each
constexpr int ROWS = THREADS / 32;

__device__ __forceinline__ float bf16_operand(float v) {
  return __bfloat162float(__float2bfloat16_rn(v));
}
__device__ __forceinline__ double bf16_operand(double v) {
  return static_cast<double>(__bfloat162float(__float2bfloat16_rn(static_cast<float>(v))));
}

template <typename T, bool BF16>
__global__ void __launch_bounds__(THREADS)
gather_L_kernel(const int64_t* __restrict__ rowptr, const int* __restrict__ col,
                const T* __restrict__ w, const T* __restrict__ u, T* __restrict__ out, int n) {
  const int lane = threadIdx.x & 31;
  const long long row = static_cast<long long>(blockIdx.x) * ROWS + (threadIdx.x >> 5);
  if (row >= n) return;
  const int64_t lo = rowptr[row], hi = rowptr[row + 1];
  T acc = T(0);
  for (int64_t k = lo + lane; k < hi; k += 32) {
    T v = __ldg(u + __ldg(col + k));
    if (BF16) v = bf16_operand(v);
    acc += __ldg(w + k) * v;
  }
#pragma unroll
  for (int off = 16; off > 0; off >>= 1) acc += __shfl_xor_sync(0xffffffffu, acc, off);
  if (lane == 0) out[row] = acc;
}

template <typename T>
int launch(int bf16, const void* rowptr, const void* col, const void* w, const void* u,
           void* out, int n, void* stream) {
  if (n <= 0) return 0;
  const int blocks = (n + ROWS - 1) / ROWS;
  auto s = static_cast<cudaStream_t>(stream);
  auto rp = static_cast<const int64_t*>(rowptr);
  auto c = static_cast<const int*>(col);
  auto wt = static_cast<const T*>(w);
  auto ut = static_cast<const T*>(u);
  auto o = static_cast<T*>(out);
  if (bf16)
    gather_L_kernel<T, true><<<blocks, THREADS, 0, s>>>(rp, c, wt, ut, o, n);
  else
    gather_L_kernel<T, false><<<blocks, THREADS, 0, s>>>(rp, c, wt, ut, o, n);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

extern "C" int nlheat_gather_L(int dtype, int bf16, const void* rowptr, const void* col,
                               const void* w, const void* u, void* out, int n, void* stream) {
  if (dtype == 0) return launch<float>(bf16, rowptr, col, w, u, out, n, stream);
  if (dtype == 1) return launch<double>(bf16, rowptr, col, w, u, out, n, stream);
  return -1;
}
