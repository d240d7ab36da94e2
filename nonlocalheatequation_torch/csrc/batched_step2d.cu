// One fused forward-Euler step of B independent 2D solves in one launch, for
// NVIDIA Hopper (sm_90a).
//
// Replaces the Pallas TPU kernel
//   batched_step2d <- nonlocalheatequation_tpu/ops/pallas_kernel.py:
//                     _build_batched_step_kernel
//                     (make_batched_pallas_multi_step_fn, the ensemble
//                     engine's per-step composition)
//
// The case stack is (B, nx, ny), unpadded: out-of-domain window cells read
// 0 (the volumetric boundary condition).  Lane b of a launch gives the bits
// of one step2d launch on case b, and of the plain versions' disc_sum order
// (ops/cuda_kernel.py), on every input.
//
// The order of the adds (the contract shared with stencil_tile.cuh, whose
// body step2d, carried2d, superstep2d and the other batched kernels run):
//   1. every window row's column sums W_0 = row[0], W_h = (W_{h-1} +
//      row[-h]) + row[+h], one pair of columns per height h;
//   2. each output starts from 0 and adds W_{h_i} of the window row at x
//      offset i for the 2eps+1 offsets i, heights ascending, then i
//      ascending within a height (h_i = trunc(sqrt(eps^2 - (i-eps)^2)));
//   3. the epilogue u + dt*(scale*(nsum - wsum*u) [+ cg*G + clg*L(G)]), every
//      multiply and add rounded on its own (stencil_tile.cuh).
//
// Design, for 0 <= eps <= FAST_MAX_EPS (16).  A persistent grid walks the
// (case, row tile, column tile) lattice; a block of 32 x 4 threads owns a
// tile of RUN*4 rows x 32 columns (RUN = 32 rows a thread in float32, 16 in
// float64).  Its (tile + 2eps)^2 window is staged by cp.async (4- or 8-byte
// copies, the out-of-domain cells zero-filled by the copy itself) into one
// of two shared-memory buffers while the block computes the previous tile
// from the other, so the load of tile t+1 overlaps the sums of tile t.  A
// thread owns one column and RUN output rows: it keeps W_h of the RUN + 2eps
// window rows it needs in registers, advances every one a height at a time
// (two shared-memory reads each), and adds each height's x offsets to its RUN
// sums straight from those registers.  eps is a template parameter, so the
// offsets of a height are constants and every register index is fixed at
// compile time.  No barrier falls inside a tile's sums.  In the bf16
// operand tier the block rounds its staged window in place once (the same
// float -> bfloat16 -> state rounding as stencil_tile.cuh) and the carry is
// read unrounded from the state.
//
// eps 17-64 run the shared tile body (stencil_tile.cuh: one 32 x 32 tile a
// block, the case as blockIdx.z), which gives the same bits; eps 0-16 run
// the design above.
//
// What bounds it on an H100 SXM (published peaks, computed, not measured):
// bytes.  One state read and one written per step: at 8 x 1024^2, eps=8,
// f32, 2 x 32 MiB, about 0.020 ms at 3.35 TB/s, against 41 adds per point
// (about 0.005 ms at 67 TFLOP/s); the test form also reads G and L(G),
// twice the bytes.  Inside the SM the shared-memory reads come next: about
// 2*eps*(RUN+2eps)/RUN + 2 a point (26 at eps=8, f32), which the design
// keeps at one read per add of step 1 and none for step 2.
//
// Plain C interface (ops/_build.py, ops/cuda_batched.py): launches on the
// given stream, allocates nothing, returns cudaGetLastError() (0 =
// launched), or -1 when eps, the shared-memory tile, the grid or the case
// count is beyond the kernel's limits.  These limits live here only.

#include "stencil_tile.cuh"

#include <cstdint>

namespace {

using namespace nlheat;

constexpr int MAX_CASES = 65535;  // gridDim.z of the shared tile body
constexpr int FAST_MAX_EPS = 16;  // the register design's largest eps
constexpr int FAST_TY = 4;        // thread rows of a register-design block
constexpr int FAST_THREADS = 32 * FAST_TY;

// trunc(sqrt(v)) of a small non-negative integer: the same value as
// make_plan's double-precision sqrt for every eps <= MAX_EPS
__host__ __device__ constexpr int isqrt(int v) {
  int r = 0;
  while ((r + 1) * (r + 1) <= v) ++r;
  return r;
}

// the column half-height h_i of x offset i (ops/stencil.column_half_heights)
__host__ __device__ constexpr int col_height(int eps, int i) {
  return isqrt(eps * eps - (i - eps) * (i - eps));
}

template <typename T>
struct Fast {
  static constexpr int RUN = sizeof(T) == 4 ? 32 : 16;  // output rows a thread
  static constexpr int ROWS = RUN * FAST_TY;              // output rows a tile
  static constexpr int COLS = 32;                         // output columns a tile
};

template <typename T, int EPS>
__host__ __device__ constexpr size_t fast_buffer_elems() {
  return static_cast<size_t>(Fast<T>::ROWS + 2 * EPS) * (Fast<T>::COLS + 2 * EPS);
}

__device__ inline void cp_async_commit() { asm volatile("cp.async.commit_group;\n" ::: "memory"); }

template <int N>
__device__ inline void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N) : "memory");
}

// One value from global to shared memory; valid == false fills 0 and reads
// nothing.
template <typename T>
__device__ inline void cp_async_value(T* dst, const T* src, bool valid) {
  const unsigned s = static_cast<unsigned>(__cvta_generic_to_shared(dst));
  const int bytes = valid ? static_cast<int>(sizeof(T)) : 0;
  if constexpr (sizeof(T) == 4)
    asm volatile("cp.async.ca.shared.global [%0], [%1], 4, %2;\n" ::"r"(s), "l"(src),
                 "r"(bytes) : "memory");
  else
    asm volatile("cp.async.ca.shared.global [%0], [%1], 8, %2;\n" ::"r"(s), "l"(src),
                 "r"(bytes) : "memory");
}

struct TileIndex {
  int b, x0, y0;
};

__device__ inline TileIndex tile_of(long long t, int ntx, int nty, int rows, int cols) {
  const long long tx = t / nty;
  TileIndex ti;
  ti.y0 = static_cast<int>(t - tx * nty) * cols;
  ti.b = static_cast<int>(tx / ntx);
  ti.x0 = static_cast<int>(tx - static_cast<long long>(ti.b) * ntx) * rows;
  return ti;
}

// Stage tile ti's window: cell (a, c) is case ti.b's (x0 - EPS + a, y0 - EPS
// + c), 0 outside the plane.
template <typename T, int EPS>
__device__ void stage_window(T* buf, const T* u, int nx, int ny, TileIndex ti) {
  constexpr int WR = Fast<T>::ROWS + 2 * EPS, WC = Fast<T>::COLS + 2 * EPS;
  const T* ub = u + static_cast<size_t>(ti.b) * nx * ny;
  const int tid = threadIdx.y * 32 + threadIdx.x;
  for (int idx = tid; idx < WR * WC; idx += FAST_THREADS) {
    const int a = idx / WC, c = idx - a * WC;
    const int x = ti.x0 - EPS + a, y = ti.y0 - EPS + c;
    const bool in = x >= 0 && x < nx && y >= 0 && y < ny;
    cp_async_value(buf + idx, in ? ub + static_cast<size_t>(x) * ny + y : ub, in);
  }
}

template <typename T, typename OpT, int EPS>
__global__ void __launch_bounds__(FAST_THREADS)
batched_step2d_fast(const T* __restrict__ u, T* __restrict__ out, int nx, int ny, int ntx,
                    int nty, long long ntiles, const T* __restrict__ params, T wsum,
                    const T* __restrict__ g, const T* __restrict__ lg,
                    const T* __restrict__ coefs) {
  constexpr int RUN = Fast<T>::RUN, ROWS = Fast<T>::ROWS, COLS = Fast<T>::COLS;
  constexpr int WC = COLS + 2 * EPS;
  constexpr int NW = RUN + 2 * EPS;  // window rows a thread sums
  constexpr size_t BUF = fast_buffer_elems<T, EPS>();
  extern __shared__ __align__(16) unsigned char smem_raw[];
  T* bufs = reinterpret_cast<T*>(smem_raw);
  const int tx = threadIdx.x, r0 = threadIdx.y * RUN;

  long long t = blockIdx.x;
  if (t < ntiles) stage_window<T, EPS>(bufs, u, nx, ny, tile_of(t, ntx, nty, ROWS, COLS));
  cp_async_commit();
  int cur = 0;
  for (; t < ntiles; t += gridDim.x) {
    const long long tn = t + gridDim.x;
    if (tn < ntiles)
      stage_window<T, EPS>(bufs + (cur ^ 1) * BUF, u, nx, ny, tile_of(tn, ntx, nty, ROWS, COLS));
    cp_async_commit();
    cp_async_wait<1>();  // this tile's copies have landed (the next tile's may not)
    __syncthreads();
    T* win = bufs + cur * BUF;
    if constexpr (!std::is_same<T, OpT>::value) {
      for (int idx = threadIdx.y * 32 + tx; idx < static_cast<int>(BUF); idx += FAST_THREADS)
        win[idx] = Operand<T, OpT>::round(win[idx]);
      __syncthreads();
    }

    // steps 1 and 2 of the order in the header, W_h in registers
    const T* col = win + r0 * WC + tx + EPS;
    T W[NW];
    T acc[RUN];
#pragma unroll
    for (int a = 0; a < NW; ++a) W[a] = col[a * WC];
#pragma unroll
    for (int r = 0; r < RUN; ++r) acc[r] = T(0);
#pragma unroll
    for (int h = 0; h <= EPS; ++h) {
      if (h > 0) {
#pragma unroll
        for (int a = 0; a < NW; ++a) {
          W[a] = W[a] + col[a * WC - h];
          W[a] = W[a] + col[a * WC + h];
        }
      }
#pragma unroll
      for (int i = 0; i <= 2 * EPS; ++i) {
        if (col_height(EPS, i) == h) {
#pragma unroll
          for (int r = 0; r < RUN; ++r) acc[r] = acc[r] + W[r + i];
        }
      }
    }

    // step 3
    const TileIndex ti = tile_of(t, ntx, nty, ROWS, COLS);
    const size_t base = static_cast<size_t>(ti.b) * nx * ny;
    const T scale = params[2 * ti.b], dt = params[2 * ti.b + 1];
    const int y = ti.y0 + tx;
#pragma unroll
    for (int r = 0; r < RUN; ++r) {
      const int x = ti.x0 + r0 + r;
      if (x < nx && y < ny) {
        const size_t o = base + static_cast<size_t>(x) * ny + y;
        const T center = col[(r + EPS) * WC];
        T du = operator_du(acc[r], center, scale, wsum);
        if (g != nullptr)
          du = add_source(du, coefs[2 * ti.b], g[o], coefs[2 * ti.b + 1], lg[o]);
        const T carry = std::is_same<T, OpT>::value ? center : u[o];
        out[o] = euler(carry, dt, du);
      }
    }
    __syncthreads();  // every read of this buffer is done before it is staged again
    cur ^= 1;
  }
  cp_async_wait<0>();
}

template <typename T, typename OpT, int EPS>
int launch_fast(const T* u, T* out, const T* g, const T* lg, const T* coefs, const T* params,
                int batch, int nx, int ny, double wsum, cudaStream_t stream) {
  auto kernel = batched_step2d_fast<T, OpT, EPS>;
  const size_t smem = 2 * fast_buffer_elems<T, EPS>() * sizeof(T);
  if (smem > static_cast<size_t>(smem_limit())) return -1;
  const int e = allow_smem(kernel, smem);
  if (e != 0) return e;
  // blocks an SM holds, asked once per instantiation (one card type a process)
  static int per_sm = -1;
  if (per_sm < 0) {
    int n = 0;
    const cudaError_t err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(
        &n, kernel, FAST_THREADS, smem);
    if (err != cudaSuccess) return static_cast<int>(err);
    per_sm = n > 0 ? n : 1;
  }
  const int ntx = (nx + Fast<T>::ROWS - 1) / Fast<T>::ROWS;
  const int nty = (ny + Fast<T>::COLS - 1) / Fast<T>::COLS;
  const long long ntiles = static_cast<long long>(batch) * ntx * nty;
  static const int sms = device_attr(cudaDevAttrMultiProcessorCount);
  const long long grid = ntiles < static_cast<long long>(per_sm) * sms
                             ? ntiles : static_cast<long long>(per_sm) * sms;
  kernel<<<static_cast<unsigned>(grid), dim3(32, FAST_TY), smem, stream>>>(
      u, out, nx, ny, ntx, nty, ntiles, params, static_cast<T>(wsum), g, lg, coefs);
  return static_cast<int>(cudaGetLastError());
}

// Instantiate launch_fast for eps 0..FAST_MAX_EPS by a compile-time switch.
template <typename T, typename OpT, int EPS = 0>
int dispatch_fast(int eps, const T* u, T* out, const T* g, const T* lg, const T* coefs,
                  const T* params, int batch, int nx, int ny, double wsum,
                  cudaStream_t stream) {
  if (eps == EPS)
    return launch_fast<T, OpT, EPS>(u, out, g, lg, coefs, params, batch, nx, ny, wsum, stream);
  if constexpr (EPS < FAST_MAX_EPS)
    return dispatch_fast<T, OpT, EPS + 1>(eps, u, out, g, lg, coefs, params, batch, nx, ny,
                                          wsum, stream);
  return -1;
}

// The shared tile body (stencil_tile.cuh), for eps above FAST_MAX_EPS.
template <typename T, typename OpT, int MW>
__global__ void __launch_bounds__(THREADS)
batched_step2d_tile(const T* __restrict__ u, T* __restrict__ out, int nx, int ny, int eps,
                    const Plan plan, const T* __restrict__ params, T wsum,
                    const T* __restrict__ g, const T* __restrict__ lg,
                    const T* __restrict__ coefs) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  const int wc = TILE_Y + 2 * eps;
  T* tile = reinterpret_cast<T*>(smem_raw);
  T* wbuf = tile + (TILE_X + 2 * eps) * wc;
  const int tx = threadIdx.x, ty = threadIdx.y;
  const int x0 = blockIdx.y * TILE_X, y0 = blockIdx.x * TILE_Y;
  const int b = blockIdx.z;
  const size_t base = static_cast<size_t>(b) * nx * ny;  // case b's plane
  const T* ub = u + base;
  const T scale = params[2 * b], dt = params[2 * b + 1];

  load_window<T, OpT>(tile, wc, TILE_X + 2 * eps, wc, ub, nx, ny, x0 - eps, y0 - eps);
  __syncthreads();
  T acc[ROWS_PER_THREAD];
  window_sums<T, MW>(tile, wc, eps, plan, wbuf, acc);

#pragma unroll
  for (int k = 0; k < ROWS_PER_THREAD; ++k) {
    const int xl = ty + k * THREADS_Y;
    const int x = x0 + xl, y = y0 + tx;
    if (x >= nx || y >= ny) continue;
    const size_t o = static_cast<size_t>(x) * ny + y;
    const T center = tile[(xl + eps) * wc + tx + eps];
    T du = operator_du(acc[k], center, scale, wsum);
    if (g != nullptr)
      du = add_source(du, coefs[2 * b], g[base + o], coefs[2 * b + 1], lg[base + o]);
    const T carry = std::is_same<T, OpT>::value ? center : ub[o];
    out[base + o] = euler(carry, dt, du);
  }
}

template <typename T, typename OpT>
int launch(const void* u, void* out, const void* g, const void* lg, const void* coefs,
           const void* params, int batch, int nx, int ny, int eps, double wsum,
           void* stream) {
  if (eps < 0 || eps > MAX_EPS || batch < 0 || batch > MAX_CASES) return -1;
  const size_t smem = tile_smem_bytes<T>(eps);
  if (smem > static_cast<size_t>(smem_limit())) return -1;
  if ((static_cast<long long>(nx) + TILE_X - 1) / TILE_X > 65535) return -1;  // gridDim.y
  if (batch == 0 || nx <= 0 || ny <= 0) return 0;
  const auto st = static_cast<cudaStream_t>(stream);
  if (eps <= FAST_MAX_EPS)
    return dispatch_fast<T, OpT>(eps, static_cast<const T*>(u), static_cast<T*>(out),
                                 static_cast<const T*>(g), static_cast<const T*>(lg),
                                 static_cast<const T*>(coefs), static_cast<const T*>(params),
                                 batch, nx, ny, wsum, st);
  return with_mw(eps, [&](auto mw) {
    auto kernel = batched_step2d_tile<T, OpT, decltype(mw)::value>;
    const int e = allow_smem(kernel, smem);
    if (e != 0) return e;
    const dim3 block(TILE_Y, THREADS_Y);
    const dim3 grid((ny + TILE_Y - 1) / TILE_Y, (nx + TILE_X - 1) / TILE_X, batch);
    kernel<<<grid, block, smem, st>>>(
        static_cast<const T*>(u), static_cast<T*>(out), nx, ny, eps, make_plan(eps),
        static_cast<const T*>(params), static_cast<T>(wsum), static_cast<const T*>(g),
        static_cast<const T*>(lg), static_cast<const T*>(coefs));
    return static_cast<int>(cudaGetLastError());
  });
}

template <typename T>
int step_typed(int bf16, const void* u, void* out, const void* g, const void* lg,
               const void* coefs, const void* params, int batch, int nx, int ny, int eps,
               double wsum, void* stream) {
  auto fn = bf16 ? &launch<T, __nv_bfloat16> : &launch<T, T>;
  return fn(u, out, g, lg, coefs, params, batch, nx, ny, eps, wsum, stream);
}

}  // namespace

// dtype: 0 = float32, 1 = float64.  bf16: 1 selects the bfloat16 operand
// tier.  u and out are (batch, nx, ny) stacks that must not overlap; params
// is the (batch, 2) table of each case's (scale, dt) in the state type.
// g == nullptr selects the production form; otherwise g and lg are the
// (batch, nx, ny) manufactured-source profiles and coefs the (batch, 2)
// table of each case's (coef_g, coef_lg) for this step.
extern "C" int nlheat_batched_step2d(int dtype, int bf16, const void* u, void* out,
                                     const void* g, const void* lg, const void* coefs,
                                     const void* params, int batch, int nx, int ny, int eps,
                                     double wsum, void* stream) {
  if (dtype == 0)
    return step_typed<float>(bf16, u, out, g, lg, coefs, params, batch, nx, ny, eps, wsum,
                             stream);
  if (dtype == 1)
    return step_typed<double>(bf16, u, out, g, lg, coefs, params, batch, nx, ny, eps, wsum,
                              stream);
  return -1;
}
