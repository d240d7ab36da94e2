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
// The order of adds.  A row has 32 slot accumulators: slot j sums the
// entries lo+j, lo+j+32, ... in ascending order (acc += w[k] * v, one FMA
// each), and the slots meet in the xor tree 16, 8, 4, 2, 1.  The order is
// fixed by the row and not by the launch, so repeated launches, every group
// width and visit order below, and the lanes of a stacked ensemble chunk
// give the same bits as a solo run, and as the first form of this kernel
// (one warp a row, lane l the slot l).
//
// Design.  A group of G lanes a row, G in {4, 8, 16, 32} (ops/gather.py
// gather_width picks it from the table's mean entries a row), 32/G rows a
// warp, 128 threads a block.  Lane l of a group holds the slots l + G*m,
// m < 32/G: the tree's levels at offsets >= G are adds between a lane's own
// registers, those below G xor shuffles inside the group; addition
// commutes, so lane 0 of the group ends with the same sum for every G.  In
// row order one lane of the warp reads each row pointer once and a shuffle
// hands the bounds to the group.  With a visit order (ops/gather.py
// gather_order: the Morton order of the points, for a shuffled numbering)
// the warp's groups take the rows order[...] instead; the table and the
// numbering stay as they are.
//
// What bounds it on an H100 SXM (published peaks, computed, not measured):
// bytes.  Each baked entry's weight and column are read once (8 bytes in
// f32), the state and the output once: 0.0191 ms at the shuffled 512^2
// cloud (262,144 nodes, 7.5 M entries), 0.0352 ms at bench.py's graded
// 256^2 cloud (65,536 nodes, 14.6 M entries).  The first form waited on
// latency: with one warp a row and one entry in flight a lane, a shuffled
// row of 28 entries was one chain of dependent loads.  Here a lane
// issues all its NL column and weight loads of an iteration before the
// first gather of u, so a warp keeps 32*NL of each in flight whatever the
// row length.  Columns and weights are streamed (evict-first in L1,
// __ldcs) so that L1 keeps u, read through __ldg.  What is left is the
// gathers: in a shuffled numbering each gathered value costs a 32-byte
// sector from L2 (traffic the byte bound does not count; chip_smoke.py
// times torch's gather u[col] alone as that floor), unless rows that share
// neighbours run together, which the Morton visit order arranges.
//
// Plain C interface (ops/_build.py, ops/cuda_unstructured.py): launches on
// the given stream, allocates nothing, returns cudaGetLastError() (0 =
// launched), or -1 for an unknown type or group width.  ``order`` is NULL
// for row order.

#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include <cstdint>

namespace {

constexpr int THREADS = 128;
constexpr int NL = 8;  // entries a lane loads in an iteration, before its first gather of u
constexpr unsigned FULL = 0xffffffffu;

__device__ __forceinline__ float bf16_operand(float v) {
  return __bfloat162float(__float2bfloat16_rn(v));
}
__device__ __forceinline__ double bf16_operand(double v) {
  return static_cast<double>(__bfloat162float(__float2bfloat16_rn(static_cast<float>(v))));
}

template <typename T, bool BF16, int G, bool ORDERED>
__global__ void __launch_bounds__(THREADS)
gather_L_kernel(const int64_t* __restrict__ rowptr, const int* __restrict__ col,
                const T* __restrict__ w, const T* __restrict__ u, T* __restrict__ out, int n,
                const int* __restrict__ order) {
  constexpr int S = 32 / G;     // slots a lane holds, and rows a warp holds
  constexpr int SPAN = G * NL;  // entries of a row an iteration covers (passes of 32)
  static_assert(SPAN % 32 == 0, "an iteration covers whole passes: NL a multiple of 32/G");
  const int lane = threadIdx.x & 31;
  const int gl = lane & (G - 1);  // the lane in its group
  const int gi = lane / G;        // the group in its warp
  const long long row0 =
      (static_cast<long long>(blockIdx.x) * THREADS + (threadIdx.x & ~31)) / G;
  const bool valid = row0 + gi < n;
  long long row;
  int64_t lo = 0, hi = 0;
  if (ORDERED) {
    // the group's row is the visit order's, its two pointers read by the
    // group's lanes together
    row = valid ? order[row0 + gi] : 0;
    if (valid) {
      lo = rowptr[row];
      hi = rowptr[row + 1];
    }
  } else {
    // the warp's S + 1 row pointers, one load each, handed to the groups
    int64_t rp = 0;
    if (lane <= S && row0 + lane <= n) rp = rowptr[row0 + lane];
    const int64_t first = __shfl_sync(FULL, rp, gi), last = __shfl_sync(FULL, rp, gi + 1);
    row = row0 + gi;
    if (valid) {
      lo = first;
      hi = last;
    }
  }

  T acc[S];
#pragma unroll
  for (int s = 0; s < S; ++s) acc[s] = T(0);
  for (int64_t base = lo; base < hi; base += SPAN) {
    const int64_t rem = hi - base;
    int c[NL];
    T wk[NL], v[NL];
#pragma unroll
    for (int m = 0; m < NL; ++m) {
      c[m] = 0;
      wk[m] = T(0);
      if (gl + G * m < rem) {
        c[m] = __ldcs(col + base + gl + G * m);
        wk[m] = __ldcs(w + base + gl + G * m);
      }
    }
#pragma unroll
    for (int m = 0; m < NL; ++m)
      if (gl + G * m < rem) v[m] = __ldg(u + c[m]);
    // entry m of the lane is slot gl + G*(m % S) in pass m / S: ascending
    // m is ascending k within each slot
#pragma unroll
    for (int m = 0; m < NL; ++m) {
      if (gl + G * m < rem) {
        T x = v[m];
        if (BF16) x = bf16_operand(x);
        acc[m % S] += wk[m] * x;
      }
    }
  }
  // the xor tree over the 32 slots: levels off >= G in the lane's registers
  // (slot s pairs with s + off/G), then the group's shuffles
#pragma unroll
  for (int off = 16; off >= G; off >>= 1) {
#pragma unroll
    for (int s = 0; s < off / G; ++s) acc[s] += acc[s + off / G];
  }
#pragma unroll
  for (int off = G / 2; off > 0; off >>= 1) acc[0] += __shfl_xor_sync(FULL, acc[0], off);
  if (valid && gl == 0) out[row] = acc[0];
}

template <typename T, bool BF16, int G>
int launch_g(const int64_t* rp, const int* c, const T* wt, const T* ut, T* o, int n,
             const int* order, cudaStream_t s) {
  constexpr int rows_per_block = THREADS / G;
  const int blocks = static_cast<int>((static_cast<long long>(n) + rows_per_block - 1) /
                                      rows_per_block);
  if (order)
    gather_L_kernel<T, BF16, G, true><<<blocks, THREADS, 0, s>>>(rp, c, wt, ut, o, n, order);
  else
    gather_L_kernel<T, BF16, G, false><<<blocks, THREADS, 0, s>>>(rp, c, wt, ut, o, n, order);
  return static_cast<int>(cudaGetLastError());
}

template <typename T, bool BF16>
int launch_bf(int width, const int64_t* rp, const int* c, const T* wt, const T* ut, T* o,
              int n, const int* order, cudaStream_t s) {
  switch (width) {
    case 4: return launch_g<T, BF16, 4>(rp, c, wt, ut, o, n, order, s);
    case 8: return launch_g<T, BF16, 8>(rp, c, wt, ut, o, n, order, s);
    case 16: return launch_g<T, BF16, 16>(rp, c, wt, ut, o, n, order, s);
    case 32: return launch_g<T, BF16, 32>(rp, c, wt, ut, o, n, order, s);
    default: return -1;
  }
}

template <typename T>
int launch(int bf16, int width, const void* rowptr, const void* col, const void* w,
           const void* u, void* out, int n, const void* order, void* stream) {
  if (width != 4 && width != 8 && width != 16 && width != 32) return -1;
  if (n <= 0) return 0;
  auto s = static_cast<cudaStream_t>(stream);
  auto rp = static_cast<const int64_t*>(rowptr);
  auto c = static_cast<const int*>(col);
  auto wt = static_cast<const T*>(w);
  auto ut = static_cast<const T*>(u);
  auto o = static_cast<T*>(out);
  auto ord = static_cast<const int*>(order);
  if (bf16) return launch_bf<T, true>(width, rp, c, wt, ut, o, n, ord, s);
  return launch_bf<T, false>(width, rp, c, wt, ut, o, n, ord, s);
}

}  // namespace

extern "C" int nlheat_gather_L(int dtype, int bf16, const void* rowptr, const void* col,
                               const void* w, const void* u, void* out, int n, int width,
                               const void* order, void* stream) {
  if (dtype == 0) return launch<float>(bf16, width, rowptr, col, w, u, out, n, order, stream);
  if (dtype == 1) return launch<double>(bf16, width, rowptr, col, w, u, out, n, order, stream);
  return -1;
}
