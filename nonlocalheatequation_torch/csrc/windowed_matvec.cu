// The windowed block-dense strip matvec of the unstructured operator, for
// NVIDIA Hopper (sm_90a).
//
// Replaces the Pallas TPU kernel
//   windowed_matvec <- nonlocalheatequation_tpu/ops/windowed.py:
//                      _build_windowed_matvec
//                      (_WindowedExec.neighbor_sum_perm, the
//                      layout="windowed" step of the unstructured solve)
//
// What it computes, for the Morton-ordered state u (n,) and the plan's
// strips P (nb*bm, R*we), bm = 128:
//
//   out[b*bm + i] = sum_r sum_c P[b*bm + i, r*we + c] * u[s128[b, r]*128 + c]
//
// for every row b*bm + i < n (rows past n carry zero strips and are not
// written; window cells past n read 0).  The edges outside a block's
// windows are the caller's residual (ops/windowed.py), as on the TPU.
//
// Design.  One block per row block of 128 rows.  The block's R windows
// (R*we values: 16 KB in f32 at R*we = 4096, the default plan's largest)
// are staged once into shared memory; then each warp takes rows in turn and
// streams its row of P with coalesced 16-byte loads (four floats or two
// doubles per lane, evict-first: P is read once per step), multiplying by
// the staged window values, and reduces its 32 partial sums with one fixed
// xor-shuffle tree.  The order of the adds is fixed by the row, not by the
// launch, so repeated launches give the same bits.
//
// What bounds it on an H100 SXM (published peaks, computed, not measured):
// bytes.  Each step reads the whole of P: at the shuffled 512^2 cloud
// (262,144 nodes, eps = 3h, we = 1024, R = 2) that is 2.0 GiB in f32,
// about 0.64 ms at 3.35 TB/s, against 1.1 G multiply-adds (about 0.016 ms
// at 67 TFLOP/s).  The design keeps every lane's loads 16 bytes wide and
// enough rows in flight (eight warps a block, up to eight blocks an SM at
// 8 KB of windows each) to stream P at the memory's rate.
//
// Plain C interface (ops/_build.py, ops/cuda_unstructured.py): launches on
// the given stream, allocates nothing, returns cudaGetLastError() (0 =
// launched), or -1 when the strip width is not a multiple of 128 or the
// windows exceed the block's shared memory.  These limits live here only.

#include <cuda_runtime.h>

namespace {

constexpr int BM = 128;       // rows per block (the plan's bm)
constexpr int LANE = 128;     // window starts are in 128-value units
constexpr int THREADS = 256;  // eight warps
constexpr int MAX_SMEM = 227 * 1024;

template <typename T> struct Vec;
template <> struct Vec<float> {
  using type = float4;
  static constexpr int width = 4;
};
template <> struct Vec<double> {
  using type = double2;
  static constexpr int width = 2;
};

template <typename T>
__device__ __forceinline__ T dot_vec(const float4& p, const T* w) {
  return p.x * w[0] + p.y * w[1] + p.z * w[2] + p.w * w[3];
}
template <typename T>
__device__ __forceinline__ T dot_vec(const double2& p, const T* w) {
  return p.x * w[0] + p.y * w[1];
}

template <typename T>
__global__ void __launch_bounds__(THREADS)
windowed_matvec_kernel(const T* __restrict__ P, const int* __restrict__ s128,
                       const T* __restrict__ u, T* __restrict__ out, int n, int R, int we) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  T* win = reinterpret_cast<T*>(smem_raw);
  const int b = blockIdx.x;
  const int width = R * we;
  for (int idx = threadIdx.x; idx < width; idx += THREADS) {
    const int r = idx / we;
    const long long g = static_cast<long long>(s128[b * R + r]) * LANE + (idx - r * we);
    win[idx] = g < n ? u[g] : T(0);
  }
  __syncthreads();

  using V = typename Vec<T>::type;
  constexpr int VW = Vec<T>::width;
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int nvec = width / VW;
  for (int i = warp; i < BM; i += THREADS / 32) {
    const long long row = static_cast<long long>(b) * BM + i;
    if (row >= n) break;
    const V* prow = reinterpret_cast<const V*>(P + row * width);
    T acc = T(0);
#pragma unroll 4
    for (int v = lane; v < nvec; v += 32) {
      const V p = __ldcs(prow + v);
      acc += dot_vec<T>(p, win + v * VW);
    }
#pragma unroll
    for (int off = 16; off > 0; off >>= 1) acc += __shfl_xor_sync(0xffffffffu, acc, off);
    if (lane == 0) out[row] = acc;
  }
}

template <typename T>
int launch(const void* P, const void* s128, const void* u, void* out, int n, int nb, int R,
           int we, void* stream) {
  if (R < 1 || we < LANE || we % LANE != 0) return -1;
  const size_t smem = static_cast<size_t>(R) * we * sizeof(T);
  if (smem > MAX_SMEM) return -1;
  if (n <= 0 || nb <= 0) return 0;
  if (smem > 48 * 1024) {
    cudaError_t err = cudaFuncSetAttribute(windowed_matvec_kernel<T>,
                                           cudaFuncAttributeMaxDynamicSharedMemorySize,
                                           static_cast<int>(smem));
    if (err != cudaSuccess) return static_cast<int>(err);
  }
  windowed_matvec_kernel<T><<<nb, THREADS, smem, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const T*>(P), static_cast<const int*>(s128), static_cast<const T*>(u),
      static_cast<T*>(out), n, R, we);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

extern "C" int nlheat_windowed_matvec(int dtype, const void* P, const void* s128,
                                      const void* u, void* out, int n, int nb, int R, int we,
                                      void* stream) {
  if (dtype == 0) return launch<float>(P, s128, u, out, n, nb, R, we, stream);
  if (dtype == 1) return launch<double>(P, s128, u, out, n, nb, R, we, stream);
  return -1;
}
