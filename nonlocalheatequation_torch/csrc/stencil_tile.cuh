// The tile body shared by every 2D kernel of the port: the window load, the
// per-row window sums of the masked-circle neighbour sum in their fixed
// summation order, and the forward-Euler epilogue.
//
// Counterpart of _strip_neighbor_sum (nonlocalheatequation_tpu/ops/
// pallas_kernel.py:370), which the TPU's per-step, carried, superstep and
// resident kernels share.  Every 2D kernel of the port includes it (and
// the 3D header the epilogue), so a multi-step kernel is bit-identical to
// the same number of step2d launches by construction.  Below the tile body
// it holds the register design (register_sums, which resident2d.cu also
// runs on its own lattice), the one-step walk (reg_walk) that
// batched_step2d.cu and batched_carried2d.cu run over a case stack
// (reg_tiles) and nsum2d.cu and split_nsum2d.cu over a padded frame
// (stage_frame), and the superstep levels that superstep2d.cu and
// batched_superstep2d.cu share, which add the same terms in the same order:
//
// * the sum.  One 32 x 32 output tile reads a (32+2eps) x (32+2eps) window.
//   For every window row r, W_h(r)[y] = sum_{|j|<=h} win[r][y+j] grows
//   outward one pair of columns per height h (registers), and each output
//   adds W_{h_i}(x+i) for the 2eps+1 x offsets i whose column half-height is
//   h.  Every element adds its terms in one fixed order (heights ascending,
//   then x offsets ascending; within W, centre then pairs outward) that does
//   not depend on where its tile sits.
// * the epilogue.  u + dt*(scale*(nsum - wsum*centre) [+ cg*G + clg*L(G)])
//   with every multiply and add rounded on its own (the _rn intrinsics are
//   never contracted into an FMA), so it gives the same bits in every kernel
//   that calls it, and the same bits as the plain PyTorch versions' separate
//   tensor operations on the same sum.
//
// The bf16 operand tier rounds each window cell to bfloat16 once, as it is
// loaded (or reads it from a bf16 shadow frame, which holds the same
// rounding), and accumulates in the state type; the carry reads the
// unrounded centre.

#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include <climits>
#include <cmath>
#include <cstddef>
#include <cstdint>
#include <type_traits>

namespace nlheat {

constexpr int TILE_X = 32;     // output rows (x, the slow axis) per tile
constexpr int TILE_Y = 32;     // output columns (y, contiguous) per tile
constexpr int THREADS_Y = 8;   // thread rows; one thread column per y
constexpr int THREADS = TILE_Y * THREADS_Y;
constexpr int ROWS_PER_THREAD = TILE_X / THREADS_Y;
constexpr int MAX_EPS = 64;

// Window rows a thread keeps running sums for: (TILE_X + 2eps) / THREADS_Y
// rounded up.  Kernels are instantiated for a few eps ranges so the
// register arrays stay short at the common eps (6 rows at eps <= 8).
constexpr int wrows_for(int eps) { return (TILE_X + 2 * eps + THREADS_Y - 1) / THREADS_Y; }

// The stencil plan, passed by value (kernel parameter space): the x
// offsets i in [0, 2eps] grouped by column half-height h, ascending in i
// within a group.  Group h is ord[hstart[h] .. hstart[h+1]).
struct Plan {
  int ord[2 * MAX_EPS + 1];
  int hstart[MAX_EPS + 2];
};

inline Plan make_plan(int eps) {
  // h_i = trunc(sqrt(eps^2 - d^2)) in double: ops/stencil.column_half_heights
  Plan p{};
  int h_of[2 * MAX_EPS + 1];
  for (int i = 0; i <= 2 * eps; ++i) {
    const int d = i - eps;
    h_of[i] = static_cast<int>(std::sqrt(static_cast<double>(eps * eps - d * d)));
  }
  int n = 0;
  for (int h = 0; h <= eps; ++h) {
    p.hstart[h] = n;
    for (int i = 0; i <= 2 * eps; ++i)
      if (h_of[i] == h) p.ord[n++] = i;
  }
  p.hstart[eps + 1] = n;
  return p;
}

inline int device_attr(cudaDeviceAttr attr) {
  int dev = 0, v = 0;
  cudaGetDevice(&dev);
  cudaDeviceGetAttribute(&v, attr, dev);
  return v;
}

// The most dynamic shared memory one block may opt in to (227 KB on an H100).
inline int smem_limit() {
  static const int limit = device_attr(cudaDevAttrMaxSharedMemoryPerBlockOptin);
  return limit;
}

// Raise a kernel's dynamic shared-memory limit to bytes when its dynamic
// and static_bytes of static shared memory need more than the default
// 48 KB; returns the CUDA status.
template <typename Kernel>
int allow_smem(Kernel kernel, size_t bytes, size_t static_bytes = 0) {
  if (bytes + static_bytes <= 48 * 1024) return 0;
  return static_cast<int>(cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, static_cast<int>(bytes)));
}

// The grid of a resident kernel (resident2d.cu, resident3d.cu), a cooperative
// launch of kernel with `threads` threads and smem bytes of dynamic shared
// memory a block over ntiles tiles: as many blocks as the card holds at once,
// at most one a tile.  0 (the launch is refused) when the card has no
// cooperative launch, when two frames of frame_bytes each exceed the L2, or
// when not one block fits an SM.
template <typename Kernel>
int resident_blocks(Kernel kernel, int threads, size_t smem, double frame_bytes,
                    long long ntiles) {
  if (!device_attr(cudaDevAttrCooperativeLaunch)) return 0;
  if (2.0 * frame_bytes > static_cast<double>(device_attr(cudaDevAttrL2CacheSize))) return 0;
  if (smem > static_cast<size_t>(smem_limit()) || allow_smem(kernel, smem) != 0) return 0;
  int per_sm = 0;
  if (cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, kernel, threads, smem) !=
      cudaSuccess)
    return 0;
  const long long resident =
      static_cast<long long>(per_sm) * device_attr(cudaDevAttrMultiProcessorCount);
  const long long blocks = ntiles < resident ? ntiles : resident;
  return blocks > INT_MAX ? 0 : static_cast<int>(blocks);
}

// The sum buffer: W_h of every window row of one tile, (TILE_X + 2eps) x TILE_Y.
inline size_t wbuf_elems(int eps) {
  return static_cast<size_t>(TILE_X + 2 * eps) * TILE_Y;
}

// Shared memory of a kernel that stages one tile's window: the window and
// the sum buffer.
template <typename T>
size_t tile_smem_bytes(int eps) {
  const size_t w = TILE_X + 2 * eps;
  return (w * w + wbuf_elems(eps)) * sizeof(T);
}

template <typename T, typename OpT>
struct Operand {
  __device__ static T round(T v) { return v; }
};

template <typename T>
struct Operand<T, __nv_bfloat16> {
  // the same double rounding as torch's x.to(torch.bfloat16) for float64:
  // state -> float -> bfloat16 (round to nearest even) -> state
  __device__ static T round(T v) {
    return static_cast<T>(__bfloat162float(__float2bfloat16_rn(static_cast<float>(v))));
  }
};

// A stored value as the state type (a bf16 shadow cell widens exactly).
template <typename T>
__device__ inline T to_state(T v) { return v; }
template <typename T>
__device__ inline T to_state(__nv_bfloat16 v) { return static_cast<T>(__bfloat162float(v)); }

// Loads that stay coherent with writes other blocks made earlier in the same
// launch (the resident kernels' frames, between steps): through L2,
// never the read-only path.
template <bool L2ONLY, typename S>
__device__ inline S load(const S* p) {
  if constexpr (L2ONLY) return __ldcg(p);
  return *p;
}

// Separately rounded arithmetic: never contracted into an FMA.
__device__ inline float add_rn(float a, float b) { return __fadd_rn(a, b); }
__device__ inline float sub_rn(float a, float b) { return __fsub_rn(a, b); }
__device__ inline float mul_rn(float a, float b) { return __fmul_rn(a, b); }
__device__ inline double add_rn(double a, double b) { return __dadd_rn(a, b); }
__device__ inline double sub_rn(double a, double b) { return __dsub_rn(a, b); }
__device__ inline double mul_rn(double a, double b) { return __dmul_rn(a, b); }

// du = scale*(acc - wsum*centre), the production operator.
template <typename T>
__device__ inline T operator_du(T acc, T centre, T scale, T wsum) {
  return mul_rn(scale, sub_rn(acc, mul_rn(wsum, centre)));
}

// du += coef_g*G + coef_lg*L(G), the manufactured source (test form).
template <typename T>
__device__ inline T add_source(T du, T coef_g, T g, T coef_lg, T lg) {
  du = add_rn(du, mul_rn(coef_g, g));
  return add_rn(du, mul_rn(coef_lg, lg));
}

// carry + dt*du
template <typename T>
__device__ inline T euler(T carry, T dt, T du) {
  return add_rn(carry, mul_rn(dt, du));
}

// Copy a rows x cols window into shared memory (row stride ld): cell (a, b)
// is src[r0 + a][c0 + b] of the (src_rows, src_cols) row-major source, 0
// outside it, rounded to the operand type.
template <typename T, typename OpT, bool L2ONLY = false, typename S>
__device__ void load_window(T* win, int ld, int rows, int cols, const S* src, int src_rows,
                            int src_cols, int r0, int c0) {
  const int tid = threadIdx.y * TILE_Y + threadIdx.x;
  for (int idx = tid; idx < rows * cols; idx += THREADS) {
    const int a = idx / cols, b = idx - a * cols;
    const int r = r0 + a, c = c0 + b;
    T v = T(0);
    if (r >= 0 && r < src_rows && c >= 0 && c < src_cols)
      v = to_state<T>(load<L2ONLY>(src + static_cast<size_t>(r) * src_cols + c));
    win[a * ld + b] = Operand<T, OpT>::round(v);
  }
}

// The neighbour sums of one 32 x 32 output tile whose (32+2eps)^2 window
// starts at win (row stride ld) in shared memory.  acc[k] is the sum for
// output row threadIdx.y + k*THREADS_Y, column threadIdx.x.  wbuf holds
// wbuf_elems(eps) values.  Every thread of the block calls it (it holds
// barriers); it ends with a barrier, so the caller may overwrite wbuf or the
// window right after.
template <typename T, int MW>
__device__ void window_sums(const T* win, int ld, int eps, const Plan& plan, T* wbuf,
                            T (&acc)[ROWS_PER_THREAD]) {
  const int tx = threadIdx.x, ty = threadIdx.y;
  const int wr = TILE_X + 2 * eps;
#pragma unroll
  for (int k = 0; k < ROWS_PER_THREAD; ++k) acc[k] = T(0);
  T wrow[MW];  // W_h of window rows ty + m*THREADS_Y, column tx
#pragma unroll
  for (int m = 0; m < MW; ++m) {
    const int a = ty + m * THREADS_Y;
    wrow[m] = a < wr ? win[a * ld + tx + eps] : T(0);
  }
  for (int h = 0; h <= eps; ++h) {
    if (h > 0) {
#pragma unroll
      for (int m = 0; m < MW; ++m) {
        const int a = ty + m * THREADS_Y;
        if (a < wr) {
          const T* row = win + a * ld + tx + eps;
          wrow[m] = wrow[m] + row[-h];
          wrow[m] = wrow[m] + row[h];
        }
      }
    }
    const int p0 = plan.hstart[h], p1 = plan.hstart[h + 1];
    if (p0 == p1) continue;  // no column of this height; uniform over the block
    __syncthreads();         // the previous height's reads of wbuf are done
#pragma unroll
    for (int m = 0; m < MW; ++m) {
      const int a = ty + m * THREADS_Y;
      if (a < wr) wbuf[a * TILE_Y + tx] = wrow[m];
    }
    __syncthreads();
    for (int p = p0; p < p1; ++p) {
      const int i = plan.ord[p];
#pragma unroll
      for (int k = 0; k < ROWS_PER_THREAD; ++k)
        acc[k] = acc[k] + wbuf[(ty + k * THREADS_Y + i) * TILE_Y + tx];
    }
  }
  __syncthreads();
}

// Instantiate f for the register-array length that covers eps: calls
// f(std::integral_constant<int, MW>{}) and returns its status.
template <typename F>
int with_mw(int eps, F f) {
  if (eps <= 8) return f(std::integral_constant<int, wrows_for(8)>{});
  if (eps <= 16) return f(std::integral_constant<int, wrows_for(16)>{});
  if (eps <= 32) return f(std::integral_constant<int, wrows_for(32)>{});
  return f(std::integral_constant<int, wrows_for(MAX_EPS)>{});
}

// Instantiate f for eps itself, 0 <= eps <= MAX: calls
// f(std::integral_constant<int, eps>{}) and returns its status, or -1 for an
// eps outside that range.
template <int MAX, int E = 0, typename F>
int with_eps(int eps, F f) {
  if (eps == E) return f(std::integral_constant<int, E>{});
  if constexpr (E < MAX) return with_eps<MAX, E + 1>(eps, f);
  return -1;
}

// -- the register design (batched_step2d.cu, batched_carried2d.cu, nsum2d.cu,
// split_nsum2d.cu, superstep2d.cu, batched_superstep2d.cu, fused_nsum2d.cu,
// resident2d.cu) ------------------------------------------------------------------
//
// eps is a template parameter, so every offset below is a constant and every
// register index is fixed at compile time.  Windows are staged by cp.async:
// a copy whose source size is 0 writes a zero and reads nothing, so cells
// outside the domain (the boundary condition) cost no branch around the copy.

// The one-step tile of batched_step2d.cu and fused_nsum2d.cu: a block of 32
// x REG_TY threads owns ROWS x COLS outputs, each thread one column of RUN
// rows (RUN = 32 in float32, 16 in float64, which keeps RUN + 2eps window
// sums and RUN outputs in registers up to eps 16; superstep_levels' items
// are RUN rows too).
constexpr int REG_TY = 4;
constexpr int REG_THREADS = 32 * REG_TY;

template <typename T>
struct RegTile {
  static constexpr int RUN = sizeof(T) == 4 ? 32 : 16;  // output rows a thread
  static constexpr int ROWS = RUN * REG_TY;              // output rows a tile
  static constexpr int COLS = 32;                        // output columns a tile
};

// Cells of one tile's (ROWS + 2eps) x (COLS + 2eps) window.
template <typename T, int EPS>
__host__ __device__ constexpr size_t reg_window_elems() {
  return static_cast<size_t>(RegTile<T>::ROWS + 2 * EPS) * (RegTile<T>::COLS + 2 * EPS);
}

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

// values a 16-byte copy moves
template <typename T>
__host__ __device__ constexpr int vec_width() { return 16 / static_cast<int>(sizeof(T)); }

// Sixteen bytes from global to shared memory, both 16-byte aligned; valid ==
// false fills zeros and reads nothing.
__device__ inline void cp_async_16(void* dst, const void* src, bool valid) {
  const unsigned s = static_cast<unsigned>(__cvta_generic_to_shared(dst));
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(s), "l"(src),
               "r"(valid ? 16 : 0) : "memory");
}

// The 2D neighbour sums of RUN outputs down one column, in the order of the
// tile body (window_sums) with W_h in registers.  col points at the centre
// column of window row 0 (row stride ld); window rows 0 .. RUN+2EPS-1 feed
// outputs 0 .. RUN-1.  Each window row's W_h grows from W_0 = row[0] as
// (W_{h-1} + row[-h]) + row[+h], two shared-memory reads a height, and each
// output adds W_{h_i} of its x offsets i from 0, heights ascending, then i
// ascending, straight from the registers.  Every cell read is rounded to the
// operand type OpT (a no-op when OpT is the state type).  No barrier.
template <typename T, typename OpT, int EPS, int RUN>
__device__ __forceinline__ void register_sums(const T* col, int ld, T (&acc)[RUN]) {
  constexpr int NW = RUN + 2 * EPS;  // window rows the column sums
  T W[NW];
#pragma unroll
  for (int a = 0; a < NW; ++a) W[a] = Operand<T, OpT>::round(col[a * ld]);
#pragma unroll
  for (int r = 0; r < RUN; ++r) acc[r] = T(0);
#pragma unroll
  for (int h = 0; h <= EPS; ++h) {
    if (h > 0) {
#pragma unroll
      for (int a = 0; a < NW; ++a) {
        W[a] = W[a] + Operand<T, OpT>::round(col[a * ld - h]);
        W[a] = W[a] + Operand<T, OpT>::round(col[a * ld + h]);
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
}

// -- one step in the register design: the walk (batched_step2d.cu,
// batched_carried2d.cu, nsum2d.cu, split_nsum2d.cu) --------------------------------
//
// A persistent grid walks a list of RegTile<T> tiles of ROWS x COLS outputs;
// a block stages the window of tile t+1 by cp.async into one of two buffers
// while it sums tile t from the other, so the load overlaps the sums.  The
// batched kernels walk the (case, row tile, column tile) lattice of a (B,
// rows, cols) stack whose case plane holds the case's cell (x, y) at (x +
// off, y + off): off = 0 for an unpadded stack, eps for a stack of frames
// (reg_tiles).  nsum2d.cu walks the tiles of one padded frame, split_nsum2d.cu
// the tiles of a phase's rectangles of one, each staged by stage_frame.

// The largest eps of the walk: a thread's RUN + 2eps column sums and RUN
// outputs stay in registers up to it.
constexpr int REG_TILES_MAX_EPS = 16;

// Whether a one-step lattice of batch planes of (nx, ny) outputs is too
// small for the walk: in float32, fewer RUN*4 x 32 tiles than the card has
// SMs (a 512^2 plane is 64 tiles), where the tile body's 32 x 32 blocks
// (256 at 512^2) fill the card and the walk's few long tiles do not; timed
// on an H100 by chip_smoke.py's lattice sweep (PERF.md section 6).  In
// float64 (RUN 16) the walk was the faster at every size swept, down to
// 256^2 (32 tiles), so it always walks.
template <typename T>
inline bool reg_tiles_too_few(long long batch, int nx, int ny) {
  if (sizeof(T) != 4) return false;
  static const int sms = device_attr(cudaDevAttrMultiProcessorCount);
  const long long tiles = batch * ((nx + RegTile<T>::ROWS - 1) / RegTile<T>::ROWS) *
                          ((ny + RegTile<T>::COLS - 1) / RegTile<T>::COLS);
  return tiles < sms;
}

struct TileIndex {
  int b, x0, y0;  // the case and the tile's first output row and column
};

__device__ inline TileIndex tile_of(long long t, int ntx, int nty, int rows, int cols) {
  const long long tx = t / nty;
  TileIndex ti;
  ti.y0 = static_cast<int>(t - tx * nty) * cols;
  ti.b = static_cast<int>(tx / ntx);
  ti.x0 = static_cast<int>(tx - static_cast<long long>(ti.b) * ntx) * rows;
  return ti;
}

// Stage tile ti's window: cell (a, c) is case ti.b's cell (x0 - EPS + a, y0
// - EPS + c), read at (x + off, y + off) of its (rows, cols) plane, 0 outside
// the plane.
template <typename T, int EPS>
__device__ void stage_window(T* buf, const T* src, int rows, int cols, int off, TileIndex ti) {
  constexpr int WR = RegTile<T>::ROWS + 2 * EPS, WC = RegTile<T>::COLS + 2 * EPS;
  const T* plane = src + static_cast<size_t>(ti.b) * rows * cols;
  const int tid = threadIdx.y * 32 + threadIdx.x;
  for (int idx = tid; idx < WR * WC; idx += REG_THREADS) {
    const int a = idx / WC, c = idx - a * WC;
    const int x = ti.x0 - EPS + off + a, y = ti.y0 - EPS + off + c;
    const bool in = x >= 0 && x < rows && y >= 0 && y < cols;
    cp_async_value(buf + idx, in ? plane + static_cast<size_t>(x) * cols + y : plane, in);
  }
}

// The persistent walk over tiles 0 .. ntiles-1: every thread of the 32 x
// REG_TY block calls it.  stage(buf, t) issues the cp.async copies of tile
// t's (ROWS + 2EPS) x (COLS + 2EPS) window into buf (row stride WC = COLS +
// 2EPS) and commits nothing.  For each tile the block rounds the staged
// window to the operand type in place (the bf16 tier), sums it with
// register_sums, and calls epilogue(t, col, acc): col is this thread's
// column of the window at the centre of its first output row's window row
// (the centre of output r is col[(r + EPS) * WC]), acc its RUN sums.  The
// shared memory holds two windows.
template <typename T, typename OpT, int EPS, typename Stage, typename Epilogue>
__device__ __forceinline__ void reg_walk(long long ntiles, Stage stage, Epilogue epilogue) {
  constexpr int RUN = RegTile<T>::RUN, WC = RegTile<T>::COLS + 2 * EPS;
  constexpr size_t BUF = reg_window_elems<T, EPS>();
  extern __shared__ __align__(16) unsigned char smem_raw[];
  T* bufs = reinterpret_cast<T*>(smem_raw);
  const int tx = threadIdx.x, r0 = threadIdx.y * RUN;

  long long t = blockIdx.x;
  if (t < ntiles) stage(bufs, t);
  cp_async_commit();
  int cur = 0;
  for (; t < ntiles; t += gridDim.x) {
    const long long tn = t + gridDim.x;
    if (tn < ntiles) stage(bufs + (cur ^ 1) * BUF, tn);
    cp_async_commit();
    cp_async_wait<1>();  // this tile's copies have landed (the next tile's may not)
    __syncthreads();
    T* win = bufs + cur * BUF;
    if constexpr (!std::is_same<T, OpT>::value) {
      for (int idx = threadIdx.y * 32 + tx; idx < static_cast<int>(BUF); idx += REG_THREADS)
        win[idx] = Operand<T, OpT>::round(win[idx]);
      __syncthreads();
    }
    const T* col = win + r0 * WC + tx + EPS;
    T acc[RUN];
    register_sums<T, T, EPS, RUN>(col, WC, acc);
    epilogue(t, col, acc);
    __syncthreads();  // every read of this buffer is done before it is staged again
    cur ^= 1;
  }
  cp_async_wait<0>();
}

// reg_walk over the (case, row tile, column tile) lattice of a case stack,
// ntx row tiles by nty column tiles a case, each window staged by
// stage_window; epilogue(ti, col, acc) gets the tile's TileIndex.
template <typename T, typename OpT, int EPS, typename Epilogue>
__device__ __forceinline__ void reg_tiles(const T* __restrict__ src, int rows, int cols, int off,
                                          int ntx, int nty, long long ntiles,
                                          Epilogue epilogue) {
  constexpr int RUN = RegTile<T>::RUN, ROWS = RegTile<T>::ROWS, COLS = RegTile<T>::COLS;
  reg_walk<T, OpT, EPS>(
      ntiles,
      [&](T* buf, long long t) {
        stage_window<T, EPS>(buf, src, rows, cols, off, tile_of(t, ntx, nty, ROWS, COLS));
      },
      [&](long long t, const T* col, const T (&acc)[RUN]) {
        epilogue(tile_of(t, ntx, nty, ROWS, COLS), col, acc);
      });
}

// The cells of a (rows, cols) frame that a stage may read, [r0, r1) x [c0,
// c1); the others are zero-filled.
struct Span2 {
  int r0, r1, c0, c1;
};

// Whether stage_frame may copy 16 bytes a copy: the frame's base and row
// pitch (cols) and the window's row width (COLS + 2EPS) are 16-byte
// aligned, and so are the span's column edges, unless no window of the
// launch crosses them (edges_crossed false).  A window's origin column is a
// multiple of COLS, so it is aligned with the rows.
template <typename T, int EPS>
inline bool stage_frame_vec(const void* frame, int cols, const Span2& span, bool edges_crossed) {
  constexpr int V = vec_width<T>();
  return reinterpret_cast<uintptr_t>(frame) % 16 == 0 && cols % V == 0 &&
         (RegTile<T>::COLS + 2 * EPS) % V == 0 &&
         (!edges_crossed || (span.c0 % V == 0 && span.c1 % V == 0));
}

// Stage the window whose cell (a, c) is frame cell (x + a, y + c) of the
// row-major frame of row pitch cols, 0 outside span: 16 bytes a copy with
// vec (stage_frame_vec), else a value a copy.
template <typename T, int EPS>
__device__ __forceinline__ void stage_frame(T* buf, const T* frame, int cols, const Span2& span,
                                            int x, int y, bool vec) {
  constexpr int WR = RegTile<T>::ROWS + 2 * EPS, WC = RegTile<T>::COLS + 2 * EPS;
  const int tid = threadIdx.y * 32 + threadIdx.x;
  if (vec) {
    constexpr int V = vec_width<T>(), PER_ROW = WC / V;
    for (int idx = tid; idx < WR * PER_ROW; idx += REG_THREADS) {
      const int a = idx / PER_ROW, c = (idx - a * PER_ROW) * V;
      const int r = x + a, q = y + c;
      const bool in = r >= span.r0 && r < span.r1 && q >= span.c0 && q + V <= span.c1;
      cp_async_16(buf + a * WC + c, in ? frame + static_cast<size_t>(r) * cols + q : frame, in);
    }
    return;
  }
  for (int idx = tid; idx < WR * WC; idx += REG_THREADS) {
    const int a = idx / WC, c = idx - a * WC;
    const int r = x + a, q = y + c;
    const bool in = r >= span.r0 && r < span.r1 && q >= span.c0 && q < span.c1;
    cp_async_value(buf + idx, in ? frame + static_cast<size_t>(r) * cols + q : frame, in);
  }
}

// Launch kernel, a reg_tiles kernel of this T and EPS, over ntiles tiles: as
// many 32 x REG_TY blocks as the card holds at once (per_sm: the caller's
// cache of the blocks an SM holds, -1 until asked; one card type a
// process), at most one a tile.  -1 when the two windows exceed a block's
// shared memory, else the CUDA status.
template <typename T, int EPS, typename Kernel, typename... Args>
int reg_tiles_launch(Kernel kernel, long long ntiles, int& per_sm, cudaStream_t stream,
                     Args... args) {
  const size_t smem = 2 * reg_window_elems<T, EPS>() * sizeof(T);
  if (smem > static_cast<size_t>(smem_limit())) return -1;
  const int e = allow_smem(kernel, smem);
  if (e != 0) return e;
  if (per_sm < 0) {
    int n = 0;
    const cudaError_t err =
        cudaOccupancyMaxActiveBlocksPerMultiprocessor(&n, kernel, REG_THREADS, smem);
    if (err != cudaSuccess) return static_cast<int>(err);
    per_sm = n > 0 ? n : 1;
  }
  static const int sms = device_attr(cudaDevAttrMultiProcessorCount);
  const long long cap = static_cast<long long>(per_sm) * sms;
  const long long grid = ntiles < cap ? ntiles : cap;
  kernel<<<static_cast<unsigned>(grid), dim3(32, REG_TY), smem, stream>>>(args...);
  return static_cast<int>(cudaGetLastError());
}

// -- K steps by temporal blocking in the register design (superstep2d.cu,
// batched_superstep2d.cu) -------------------------------------------------------
//
// A block owns an OT x OT output tile of one (nx, ny) plane and stages the
// window widened by K*eps per side, S = OT + 2K*eps, in shared memory; level
// j computes the band of side OT + 2(K-j)*eps from level j-1's band, masked
// to the plane (0 outside, the boundary condition re-applied every level),
// so level j is what j step2d launches give.  Only level K, the output
// tile, is written to device memory.  superstep2d.cu describes the design.

constexpr int SUPERSTEP_MAX_K = 4;
constexpr int SUPERSTEP_FAST_MAX_EPS = 8;  // the register design's largest eps

// Shared memory of a launch: the register design's two S x S state buffers
// (eps <= SUPERSTEP_FAST_MAX_EPS), or the tile body's two (three in the bf16
// tier) and its sum buffer.
template <typename T>
size_t superstep_smem(int ot, int eps, int ksteps, bool bf16) {
  const size_t s = ot + 2 * ksteps * eps;
  if (eps <= SUPERSTEP_FAST_MAX_EPS) return 2 * s * s * sizeof(T);
  return ((bf16 ? 3 : 2) * s * s + wbuf_elems(eps)) * sizeof(T);
}

// The output tile side of a launch (64, or 32 where two 64-tiles do not fit
// one SM), or 0 when not even a 32-point tile fits a block's shared memory.
template <typename T>
int superstep_ot(int eps, int ksteps, bool bf16) {
  const size_t limit = static_cast<size_t>(smem_limit());
  if (superstep_smem<T>(64, eps, ksteps, bf16) <= limit / 2) return 64;
  if (superstep_smem<T>(32, eps, ksteps, bf16) <= limit) return 32;
  return 0;
}

// The K levels of block (blockIdx.x, blockIdx.y)'s tile of the plane u into
// out, in the register design: every thread of the 32 x WARPS block calls
// it.  The widened window is staged by cp.async; each level's band is cut
// into items of 32 columns by RUN rows dealt over the warps, a thread
// summing one column of an item with register_sums (the bf16 tier rounds
// every cell it reads for the sums and the operator's centre, the carry
// reads the unrounded state); one barrier separates the levels.
template <typename T, typename OpT, int EPS, int WARPS>
__device__ __forceinline__ void superstep_levels(const T* __restrict__ u, T* __restrict__ out,
                                                 int nx, int ny, int K, int ot, T scale,
                                                 T wsum, T dt) {
  constexpr int RUN = RegTile<T>::RUN;  // an item's rows
  extern __shared__ __align__(16) unsigned char smem_raw[];
  const int S = ot + 2 * K * EPS;
  T* cur = reinterpret_cast<T*>(smem_raw);
  T* nxt = cur + S * S;
  const int lane = threadIdx.x, warp = threadIdx.y;
  const int x0 = blockIdx.y * ot, y0 = blockIdx.x * ot;  // the output tile
  const int bx0 = x0 - K * EPS, by0 = y0 - K * EPS;      // buffer cell (0, 0)

  for (int idx = warp * 32 + lane; idx < S * S; idx += 32 * WARPS) {
    const int a = idx / S, c = idx - a * S;
    const int x = bx0 + a, y = by0 + c;
    const bool in = x >= 0 && x < nx && y >= 0 && y < ny;
    cp_async_value(cur + idx, in ? u + static_cast<size_t>(x) * ny + y : u, in);
  }
  cp_async_commit();
  cp_async_wait<0>();
  __syncthreads();

#pragma unroll 1
  for (int j = 1; j <= K; ++j) {
    const int band = ot + 2 * (K - j) * EPS;  // level j's band: buffer [j*EPS, j*EPS + band)
    const int lo = (j - 1) * EPS;             // its window: level j-1's band
    const int nstrip = (band + 31) / 32, nrun = (band + RUN - 1) / RUN;
#pragma unroll 1
    for (int item = warp; item < nstrip * nrun; item += WARPS) {
      const int sx = item / nstrip, sy = item - sx * nstrip;
      // the last item of a row (column) ends at the band's edge; the rows
      // (columns) it shares with the item before it are written by that one
      const int ox = min(sx * RUN, band - RUN), oy = min(sy * 32, band - 32);
      const T* col = cur + (lo + ox) * S + lo + oy + lane + EPS;
      T acc[RUN];
      register_sums<T, OpT, EPS, RUN>(col, S, acc);
      const int by = j * EPS + oy + lane, y = by0 + by;
      const bool own_col = oy + lane >= sy * 32;
#pragma unroll
      for (int r = 0; r < RUN; ++r) {
        const int bx = j * EPS + ox + r, x = bx0 + bx;
        if (!own_col || ox + r < sx * RUN) continue;
        const bool inside = x >= 0 && x < nx && y >= 0 && y < ny;
        const int o = bx * S + by;
        const T du = operator_du(acc[r], Operand<T, OpT>::round(cur[o]), scale, wsum);
        const T v = inside ? euler(cur[o], dt, du) : T(0);
        if (j < K)
          nxt[o] = v;
        else if (inside)
          out[static_cast<size_t>(x) * ny + y] = v;
      }
    }
    __syncthreads();  // level j is written before level j+1 reads it
    T* t = cur;
    cur = nxt;
    nxt = t;
  }
}

// The K levels of block (blockIdx.x, blockIdx.y)'s tile in the shared tile
// body, for eps above SUPERSTEP_FAST_MAX_EPS: every thread of the 32 x
// THREADS_Y block calls it.  Each level's band is summed as 32 x 32
// sub-tiles one after another (window_sums, two barriers a height); the
// bf16 tier first rounds the band a level reads into a third buffer.
template <typename T, typename OpT, int MW, int K>
__device__ __forceinline__ void superstep_tile_levels(const T* __restrict__ u,
                                                      T* __restrict__ out, int nx, int ny,
                                                      int eps, int ot, const Plan& plan,
                                                      T scale, T wsum, T dt) {
  constexpr bool BF16 = !std::is_same<T, OpT>::value;
  extern __shared__ __align__(16) unsigned char smem_raw[];
  const int S = ot + 2 * K * eps;
  T* cur = reinterpret_cast<T*>(smem_raw);
  T* nxt = cur + S * S;
  T* opnd = nxt + S * S;  // bf16 tier only
  T* wbuf = opnd + (BF16 ? S * S : 0);
  const int tx = threadIdx.x, ty = threadIdx.y;
  const int x0 = blockIdx.y * ot, y0 = blockIdx.x * ot;  // the output tile
  const int bx0 = x0 - K * eps, by0 = y0 - K * eps;      // buffer cell (0, 0)

  load_window<T, T>(cur, S, S, S, u, nx, ny, bx0, by0);
  __syncthreads();

#pragma unroll 1
  for (int j = 1; j <= K; ++j) {
    const int band = ot + 2 * (K - j) * eps;  // level j's band: buffer [j*eps, j*eps + band)
    const int lo = (j - 1) * eps;             // its window: level j-1's band
    const T* op = cur;
    if constexpr (BF16) {
      const int w = band + 2 * eps;
      const int tid = ty * TILE_Y + tx;
      for (int idx = tid; idx < w * w; idx += THREADS) {
        const int a = idx / w, c = idx - a * w;
        const int o = (lo + a) * S + lo + c;
        opnd[o] = Operand<T, OpT>::round(cur[o]);
      }
      __syncthreads();
      op = opnd;
    }
    const int nsub = (band + TILE_X - 1) / TILE_X;
    for (int sx = 0; sx < nsub; ++sx) {
      for (int sy = 0; sy < nsub; ++sy) {
        const int ox = min(sx * TILE_X, band - TILE_X), oy = min(sy * TILE_Y, band - TILE_Y);
        T acc[ROWS_PER_THREAD];
        window_sums<T, MW>(op + (lo + ox) * S + lo + oy, S, eps, plan, wbuf, acc);
#pragma unroll
        for (int k = 0; k < ROWS_PER_THREAD; ++k) {
          const int bx = j * eps + ox + ty + k * THREADS_Y, by = j * eps + oy + tx;
          const int x = bx0 + bx, y = by0 + by;
          const bool inside = x >= 0 && x < nx && y >= 0 && y < ny;
          const int o = bx * S + by;
          const T du = operator_du(acc[k], op[o], scale, wsum);
          const T v = inside ? euler(cur[o], dt, du) : T(0);
          if (j < K)
            nxt[o] = v;
          else if (inside)
            out[static_cast<size_t>(x) * ny + y] = v;
        }
      }
    }
    __syncthreads();  // level j is written before level j+1 reads it
    T* t = cur;
    cur = nxt;
    nxt = t;
  }
}

// Launch a register-design superstep kernel (four and six warps, the same
// template) on an OT-tile grid: four warps a block, or six where the shared
// memory admits just two blocks an SM (K=3 at eps=8 in float32), where four
// leave the SM too few warps to hide the shared-memory reads (six ran faster
// there on an H100, and slower with one block or three an SM).
template <typename Four, typename Six, typename... Args>
int superstep_launch(Four four, Six six, dim3 grid, size_t smem, cudaStream_t stream,
                     Args... args) {
  int e = allow_smem(four, smem);
  if (e != 0) return e;
  int per_sm = 0;
  e = static_cast<int>(cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, four, 128, smem));
  if (e != 0) return e;
  if (per_sm == 2) {
    e = allow_smem(six, smem);
    if (e != 0) return e;
    six<<<grid, dim3(32, 6), smem, stream>>>(args...);
  } else {
    four<<<grid, dim3(32, 4), smem, stream>>>(args...);
  }
  return static_cast<int>(cudaGetLastError());
}

}  // namespace nlheat
