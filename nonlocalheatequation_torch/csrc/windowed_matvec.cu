// The windowed matvec of the unstructured operator over the packed
// in-window entries, for NVIDIA Hopper (sm_90a).
//
// Replaces the Pallas TPU kernel
//   windowed_matvec <- nonlocalheatequation_tpu/ops/windowed.py:
//                      _build_windowed_matvec
//                      (_WindowedExec.neighbor_sum_perm, the
//                      layout="windowed" step of the unstructured solve)
//
// What it computes, for the Morton-ordered state u (n,), the window starts
// s128 (nb, R) in 128-value units and the plan's in-window entries packed by
// row (ops/windowed.py: rowptr (nb*128+1,) int32; per entry its column in the
// block's concatenated R*we window, uint16, and its value in u's dtype):
//
//   out[row] = sum_{k in row} val[k] * win_b[col[k]],
//   win_b[r*we + c] = u[s128[b, r]*128 + c] (0 past n), b = row / 128,
//
// for every row < n.  It is the TPU kernel's product of the dense strips P
// (nb*128, R*we) with the windows, with P's zeros left out: entry k of a row
// is P's non-zero at that column.  The edges outside a block's windows are
// the caller's residual (ops/windowed.py), as on the TPU.
//
// Design.  One block per row block of 128 rows.  Thread 0 stages the
// block's R windows into shared memory with one bulk asynchronous copy
// (cp.async.bulk, completion on an mbarrier) per window, over the part of
// the window inside u in whole 16-byte units; the other threads meanwhile
// fill the cells past that part (u's last values, then 0 past n).  Each
// group of G = 8 lanes owns four rows of the block (32 groups); lane j takes
// entries j, j+8, j+16, ... of each row (neighbouring lanes on neighbouring
// entries, consecutive rows contiguous, so a warp's reads are coalesced).
// Before it waits for the windows, every thread reads its rows' pointers
// and its first four entries of each row (32 of a row's entries, more than
// most rows hold) into registers, so the entry stream overlaps the staging.
// Then it gathers each entry's window value from shared memory and
// accumulates val*win with fused multiply-adds in entry order (the rest of
// a longer row streamed after); the 8 lane sums of a row are added by a
// fixed xor-shuffle tree (lanes j^4, j^2, j^1).  The order of the adds is
// fixed by the row (its length and its entries' order), not by the launch:
// repeated launches give the same bits.
//
// What bounds it on an H100 SXM (published peaks, computed, not measured):
// bytes.  The same work done the least way reads each packed entry once
// (its value and its 2-byte column), the row pointer, u once and writes out
// once: at the shuffled 512^2 cloud (262,144 nodes, eps = 3h, we = 1024,
// R = 2, 7.1 M entries) 45.8 MB in f32, 0.0137 ms at 3.35 TB/s, against 2
// flops an entry (about 0.0002 ms at 67 TFLOP/s).  The dense strips of the earlier
// form (2.0 GiB a step, 1.3% non-zero) are never allocated.
//
// Plain C interface (ops/_build.py, ops/cuda_unstructured.py): launches on
// the given stream, allocates nothing, returns cudaGetLastError() (0 =
// launched), or -1 when the window width is not a multiple of 128, the
// windows exceed the block's shared memory or a uint16 column.  These
// limits live here only.

#include <cuda_runtime.h>

#include <cstdint>

namespace {

constexpr int BM = 128;       // rows per block (the plan's bm)
constexpr int LANE = 128;     // window starts are in 128-value units
constexpr int THREADS = 256;  // eight warps
constexpr int G = 8;          // lanes per row
constexpr int RPT = BM / (THREADS / G);  // rows per thread (4)
constexpr int CAP = 4;        // entries per lane and row read ahead of the windows
constexpr int MAX_SMEM = 227 * 1024;
constexpr int MAX_COLS = 65536;  // a uint16 column

__device__ inline float fma_rn(float a, float b, float c) { return __fmaf_rn(a, b, c); }
__device__ inline double fma_rn(double a, double b, double c) { return __fma_rn(a, b, c); }

__device__ inline unsigned smem_addr(const void* p) {
  return static_cast<unsigned>(__cvta_generic_to_shared(p));
}

template <typename T>
__global__ void __launch_bounds__(THREADS)
windowed_matvec_kernel(const int* __restrict__ rowptr, const unsigned short* __restrict__ cols,
                       const T* __restrict__ vals, const int* __restrict__ s128,
                       const T* __restrict__ u, T* __restrict__ out, int n, int R, int we,
                       int bulk) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  T* win = reinterpret_cast<T*>(smem_raw);
  uint64_t* bar =
      reinterpret_cast<uint64_t*>(smem_raw + static_cast<size_t>(R) * we * sizeof(T));
  const int b = blockIdx.x;
  constexpr int VEC = 16 / sizeof(T);  // values a 16-byte unit holds

  // the part of window r that one bulk copy takes: whole 16-byte units
  // inside u (bulk == 0 when u is not 16-byte aligned)
  auto bulk_values = [&](int r) -> int {
    if (!bulk) return 0;
    const long long inside =
        static_cast<long long>(n) - static_cast<long long>(s128[b * R + r]) * LANE;
    const long long v = inside < 0 ? 0 : (inside > we ? we : inside);
    return static_cast<int>(v / VEC * VEC);
  };

  // each thread's rows (grp, grp+32, grp+64, grp+96 of the block) and the
  // first CAP of its entries in each are read before the windows have
  // landed, so these loads overlap the staging
  const int lane = threadIdx.x & (G - 1), grp = threadIdx.x / G;
  int k0[RPT], k1[RPT];
  T v[RPT][CAP];
  unsigned short c[RPT][CAP];
#pragma unroll
  for (int m = 0; m < RPT; ++m) {
    const long long row = static_cast<long long>(b) * BM + grp + m * (THREADS / G);
    k0[m] = rowptr[row];
    k1[m] = rowptr[row + 1];
  }
#pragma unroll
  for (int m = 0; m < RPT; ++m)
#pragma unroll
    for (int q = 0; q < CAP; ++q) {
      const int k = k0[m] + lane + q * G;
      v[m][q] = k < k1[m] ? vals[k] : T(0);
      c[m][q] = k < k1[m] ? cols[k] : 0;
    }

  if (threadIdx.x == 0) {
    asm volatile("mbarrier.init.shared::cta.b64 [%0], 1;\n" ::"r"(smem_addr(bar)) : "memory");
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
    asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
    unsigned bytes = 0;
    for (int r = 0; r < R; ++r) bytes += static_cast<unsigned>(bulk_values(r)) * sizeof(T);
    asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n" ::"r"(
                     smem_addr(bar)),
                 "r"(bytes)
                 : "memory");
    for (int r = 0; r < R; ++r) {
      const int nv = bulk_values(r);
      if (nv > 0) {
        const T* src = u + static_cast<size_t>(s128[b * R + r]) * LANE;
        asm volatile(
            "cp.async.bulk.shared::cluster.global.mbarrier::complete_tx::bytes [%0], [%1], %2, "
            "[%3];\n" ::"r"(smem_addr(win + r * we)),
            "l"(src), "r"(static_cast<unsigned>(nv * sizeof(T))), "r"(smem_addr(bar))
            : "memory");
      }
    }
  }
  // the cells the bulk copies leave: u's values up to n, then 0
  for (int r = 0; r < R; ++r) {
    const long long start = static_cast<long long>(s128[b * R + r]) * LANE;
    for (int cc = bulk_values(r) + threadIdx.x; cc < we; cc += THREADS)
      win[r * we + cc] = start + cc < n ? u[start + cc] : T(0);
  }
  __syncthreads();  // the barrier is initialised; the filled cells are written
  {
    unsigned done = 0;
    while (!done)
      asm volatile(
          "{\n .reg .pred p;\n mbarrier.try_wait.parity.shared::cta.b64 p, [%1], 0;\n"
          " selp.u32 %0, 1, 0, p;\n}\n"
          : "=r"(done)
          : "r"(smem_addr(bar))
          : "memory");
  }

#pragma unroll
  for (int m = 0; m < RPT; ++m) {
    T acc = T(0);
#pragma unroll
    for (int q = 0; q < CAP; ++q)
      if (k0[m] + lane + q * G < k1[m]) acc = fma_rn(v[m][q], win[c[m][q]], acc);
    for (int k = k0[m] + lane + CAP * G; k < k1[m]; k += G)
      acc = fma_rn(vals[k], win[cols[k]], acc);
#pragma unroll
    for (int off = G / 2; off > 0; off >>= 1) acc += __shfl_xor_sync(0xffffffffu, acc, off);
    const long long row = static_cast<long long>(b) * BM + grp + m * (THREADS / G);
    if (lane == 0 && row < n) out[row] = acc;
  }
}

template <typename T>
int launch(const void* rowptr, const void* cols, const void* vals, const void* s128,
           const void* u, void* out, int n, int nb, int R, int we, void* stream) {
  if (R < 1 || we < LANE || we % LANE != 0) return -1;
  if (static_cast<long long>(R) * we > MAX_COLS) return -1;
  const size_t smem = static_cast<size_t>(R) * we * sizeof(T) + 16;  // windows + mbarrier
  if (smem > MAX_SMEM) return -1;
  if (n <= 0 || nb <= 0) return 0;
  if (smem > 48 * 1024) {
    cudaError_t err = cudaFuncSetAttribute(windowed_matvec_kernel<T>,
                                           cudaFuncAttributeMaxDynamicSharedMemorySize,
                                           static_cast<int>(smem));
    if (err != cudaSuccess) return static_cast<int>(err);
  }
  const int bulk = reinterpret_cast<uintptr_t>(u) % 16 == 0;
  windowed_matvec_kernel<T><<<nb, THREADS, smem, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const int*>(rowptr), static_cast<const unsigned short*>(cols),
      static_cast<const T*>(vals), static_cast<const int*>(s128), static_cast<const T*>(u),
      static_cast<T*>(out), n, R, we, bulk);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// dtype: 0 = float32, 1 = float64.  rowptr has nb*128 + 1 entries; cols
// (uint16) and vals (u's dtype) one per packed entry; s128 is (nb, R).
extern "C" int nlheat_windowed_matvec(int dtype, const void* rowptr, const void* cols,
                                      const void* vals, const void* s128, const void* u,
                                      void* out, int n, int nb, int R, int we, void* stream) {
  if (dtype == 0) return launch<float>(rowptr, cols, vals, s128, u, out, n, nb, R, we, stream);
  if (dtype == 1)
    return launch<double>(rowptr, cols, vals, s128, u, out, n, nb, R, we, stream);
  return -1;
}
