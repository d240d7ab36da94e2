// The whole forward-Euler run in one launch, for NVIDIA Hopper (sm_90a).
//
// Replaces the Pallas TPU kernel
//   resident2d <- nonlocalheatequation_tpu/ops/pallas_kernel.py:_build_resident_kernel
//                 (make_resident_multi_step_fn): all nsteps steps in one call,
//                 the state ping-ponging between two frames.
//
// The TPU kernel keeps both frames in VMEM.  Hopper has no on-chip store of
// that size a grid can share, so this is a cooperative persistent kernel:
// the grid is at most as many blocks as can be resident on the card at once
// (cudaOccupancyMaxActiveBlocksPerMultiprocessor x SMs), and each block owns
// a fixed set of output tiles for the whole run.  The two (nx + 2eps, lp)
// frames with zero halos are small enough to stay in the 50 MB L2 between
// steps, so a step costs no device-memory round trip in the regime the
// kernel is for (the reference's 50^2-400^2 ctest grids and 512^2, where one
// launch per step costs more than the step).  lp is the row ny + 2eps
// padded to a multiple of 16 bytes (the wrapper allocates the frames and
// keeps the padding zero).
//
// Design, for 0 <= eps <= REG_TILES_MAX_EPS (16): the register walk's sums
// (stencil_tile.cuh, register_sums: the column sums in registers) on tiles
// of 4*RUN x 32 outputs, one 32 x 4 block of threads a tile, RUN rows a
// thread.  RUN (8, 16 or 32 in float32; 8 or 16 in float64) is chosen here
// per grid from the card's SM count (pick_run, from a sweep at eps=8 on an
// H100): in float32 the largest whose lattice has a tile for every SM, so
// that one plane's few tiles are not left to a few SMs (RUN 8 at
// 128^2-512^2, 32 at 1024^2); in float64 16 on a lattice of half to twice as
// many tiles as SMs, else 8.  A block that owns several tiles stages the
// next one's window while it sums the current one (two buffers).  Every
// window is staged by cp.async.cg, 16 bytes a copy, which reads through L2
// and never L1 (other blocks wrote the frame earlier in the same launch): a
// tile's window starts at frame column y0, a multiple of 32, lp is whole
// copies and the window's line is padded to whole copies, its extra cells
// staged and never summed.  Nothing else reads a frame in device memory (the
// centre comes from the staged window).  The steps are separated by
// grid.sync() (per-tile step counters in device memory, each tile waiting on
// its neighbours only, ran 1-3% slower at 512^2 on an H100).  eps 17-64: the
// shared tile body, 32 x 32 tiles, its loads ld.global.cg
// (load_window<..., true>).  Both add in the tile body's order, so the run
// is bit-identical to nsteps step2d launches.
//
// The fit gate is the card's and lives here only: the kernel's block must
// be co-resident at least once per SM, and the two unpadded frames must fit
// in the L2.  A grid beyond it is refused (-1) before anything is launched.
// There is no bf16 tier (the wrapper refuses a bf16 operator).
//
// What bounds it on an H100 SXM (published peaks, computed, not measured):
// the state is read once and written once for the whole run, so at 512^2,
// eps=8, f32 the bytes take under 1 us while the step's operations (46 a
// point: the window sums shared by 32 rows, as the tile body adds them) take
// about 0.18 us per step (RUN 8's lattice repeats window sums and does 70);
// a step of one 512^2 plane is too little work to fill the card's SMs for
// long, so the latency of a tile (its staging from L2, its column sums) and
// the grid-wide barrier a step bound it.  Measured (chip_smoke.py --ab,
// NVIDIA H100 80GB HBM3, 700.00 W, PERF.md section 6): a 500-step launch at
// 512^2, eps=8, f32 takes 1.87 ms (the earlier tile body: 3.12), 3.73 us a
// step, of which the barrier is about 1.55 us (the same kernel without it:
// 2.18 us a step); one step launched alone in a CUDA graph takes 4.2 us.
//
// Plain C interface (ops/_build.py, ops/cuda_kernel.py): launches on the
// given stream, allocates nothing, returns the launch status or -1.

#include <cooperative_groups.h>

#include <cstdint>

#include "stencil_tile.cuh"

namespace cg = cooperative_groups;

namespace {

using namespace nlheat;

// The largest RUN of the state type (RegTile<T>::RUN: the register walk's).
template <typename T>
__host__ __device__ constexpr int max_run() { return RegTile<T>::RUN; }

// -- the register design (stencil_tile.cuh, register_sums), eps 0-16 ---------------

template <typename T, int EPS, int RUN>
struct Res2 {
  static constexpr int ROWS = RUN * REG_TY;  // output rows a tile
  static constexpr int COLS = 32;            // output columns a tile
  static constexpr int WR = ROWS + 2 * EPS;  // window rows
  // the window's line, COLS + 2eps cells padded to whole 16-byte copies
  static constexpr int WC =
      (COLS + 2 * EPS + vec_width<T>() - 1) / vec_width<T>() * vec_width<T>();
  static constexpr int BUF = WR * WC;
};

// Stage the window of the tile whose first output is interior cell (x0, y0):
// window cell (a, c) is frame cell (x0 + a, y0 + c), 0 outside the frame's
// R rows and lp columns; 16 bytes a copy, cp.async.cg.
template <typename T, int EPS, int RUN>
__device__ __forceinline__ void stage16(T* buf, const T* frame, int R, int lp, int x0, int y0) {
  using P = Res2<T, EPS, RUN>;
  constexpr int V = vec_width<T>(), PER_ROW = P::WC / V;
  for (int idx = threadIdx.y * 32 + threadIdx.x; idx < P::WR * PER_ROW; idx += REG_THREADS) {
    const int a = idx / PER_ROW, c = (idx - a * PER_ROW) * V;
    const int x = x0 + a, y = y0 + c;
    const bool in = x < R && y < lp;
    cp_async_16(buf + a * P::WC + c, in ? frame + static_cast<size_t>(x) * lp + y : frame, in);
  }
}

template <typename T, int EPS, int RUN>
__global__ void __launch_bounds__(REG_THREADS)
resident2d_fast(T* fa, T* fb, int nx, int ny, int lp, int nty, int ntiles, int nsteps, T scale,
                T wsum, T dt) {
  using P = Res2<T, EPS, RUN>;
  extern __shared__ __align__(16) unsigned char smem_raw[];
  T* bufs = reinterpret_cast<T*>(smem_raw);
  cg::grid_group grid = cg::this_grid();
  const int R = nx + 2 * EPS;
  const int r0 = threadIdx.y * RUN;

  for (int s = 0; s < nsteps; ++s) {
    const T* src = (s & 1) ? fb : fa;
    T* dst = (s & 1) ? fa : fb;
    int t = blockIdx.x, cur = 0;  // the grid has at most one block a tile
    stage16<T, EPS, RUN>(bufs, src, R, lp, (t / nty) * P::ROWS, (t % nty) * P::COLS);
    cp_async_commit();
    for (; t < ntiles; t += gridDim.x) {
      const int tn = t + gridDim.x;
      if (tn < ntiles)
        stage16<T, EPS, RUN>(bufs + (cur ^ 1) * P::BUF, src, R, lp, (tn / nty) * P::ROWS,
                             (tn % nty) * P::COLS);
      cp_async_commit();
      cp_async_wait<1>();  // this tile's copies have landed (the next tile's may not)
      __syncthreads();
      const T* col = bufs + cur * P::BUF + r0 * P::WC + threadIdx.x + EPS;
      T acc[RUN];
      register_sums<T, T, EPS, RUN>(col, P::WC, acc);
      const int x0 = (t / nty) * P::ROWS + r0, y = (t % nty) * P::COLS + threadIdx.x;
      if (y < ny) {
#pragma unroll
        for (int r = 0; r < RUN; ++r) {
          if (x0 + r < nx) {
            const T center = col[(r + EPS) * P::WC];
            dst[static_cast<size_t>(x0 + r + EPS) * lp + y + EPS] =
                euler(center, dt, operator_du(acc[r], center, scale, wsum));
          }
        }
      }
      __syncthreads();  // every read of this buffer is done before it is staged again
      cur ^= 1;
    }
    cp_async_wait<0>();
    if (s + 1 < nsteps) grid.sync();  // the step is written everywhere before the next reads it
  }
}

// Instantiate f for run (one of the state type's RUNs): calls
// f(std::integral_constant<int, RUN>{}), or returns -1.
template <typename T, typename F>
int with_run(int run, F f) {
  if (run == 8) return f(std::integral_constant<int, 8>{});
  if (run == 16) return f(std::integral_constant<int, 16>{});
  if constexpr (max_run<T>() >= 32)
    if (run == 32) return f(std::integral_constant<int, 32>{});
  return -1;
}

// The RUN of the lattice for an (nx, ny) grid on a card of sms SMs, from a
// sweep of RUN 8-32 over 128^2-1024^2 at eps=8 on an H100 (PERF.md section
// 6).  float32: the largest RUN whose lattice has a tile for every SM, else
// 8 (a step of a small plane is one tile's latency: more, shorter tiles
// spread it over more SMs).  float64, whose adds run at half the float32
// rate: 16 where its lattice holds sms/2 to 2*sms tiles (there the longer
// tiles' fewer redundant window sums win until the lattice outgrows one
// wave), else 8; this band was measured at eps=8 only.
template <typename T>
int pick_run(int nx, int ny, int sms) {
  const auto tiles = [&](int run) {
    return static_cast<long long>((nx + 4 * run - 1) / (4 * run)) * ((ny + 31) / 32);
  };
  if (sizeof(T) == 8) return 2 * tiles(16) >= sms && tiles(16) <= 2LL * sms ? 16 : 8;
  for (int run = max_run<T>(); run > 8; run /= 2)
    if (tiles(run) >= sms) return run;
  return 8;
}

// -- the shared tile body (stencil_tile.cuh), eps above REG_TILES_MAX_EPS ------------

template <typename T, int MW>
__global__ void __launch_bounds__(THREADS)
resident2d_kernel(T* fa, T* fb, int nx, int ny, int lp, int eps, int nsteps, const Plan plan,
                  T scale, T wsum, T dt) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  cg::grid_group grid = cg::this_grid();
  const int R = nx + 2 * eps;
  const int wc = TILE_Y + 2 * eps;
  T* tile = reinterpret_cast<T*>(smem_raw);
  T* wbuf = tile + (TILE_X + 2 * eps) * wc;
  const int tx = threadIdx.x, ty = threadIdx.y;
  const int tiles_y = (ny + TILE_Y - 1) / TILE_Y;
  const int ntiles = ((nx + TILE_X - 1) / TILE_X) * tiles_y;

  for (int s = 0; s < nsteps; ++s) {
    const T* src = (s & 1) ? fb : fa;
    T* dst = (s & 1) ? fa : fb;
    for (int t = blockIdx.x; t < ntiles; t += gridDim.x) {
      const int x0 = (t / tiles_y) * TILE_X, y0 = (t % tiles_y) * TILE_Y;  // interior
      // interior cell (x, y) is frame cell (x + eps, y + eps): the window
      // of the tile at (x0, y0) starts at frame cell (x0, y0)
      load_window<T, T, true>(tile, wc, TILE_X + 2 * eps, wc, src, R, lp, x0, y0);
      __syncthreads();
      T acc[ROWS_PER_THREAD];
      window_sums<T, MW>(tile, wc, eps, plan, wbuf, acc);
#pragma unroll
      for (int k = 0; k < ROWS_PER_THREAD; ++k) {
        const int xl = ty + k * THREADS_Y;
        const int x = x0 + xl, y = y0 + tx;
        if (x >= nx || y >= ny) continue;
        const T center = tile[(xl + eps) * wc + tx + eps];
        dst[static_cast<size_t>(x + eps) * lp + y + eps] =
            euler(center, dt, operator_du(acc[k], center, scale, wsum));
      }
      __syncthreads();  // the epilogue's reads of the tile are done
    }
    if (s + 1 < nsteps) grid.sync();  // the step is written everywhere before the next reads it
  }
}

// -- the gate and the launch -------------------------------------------------------

double frame_bytes(int nx, int ny, int eps, size_t elem) {
  return (nx + 2.0 * eps) * (ny + 2.0 * eps) * elem;
}

// Calls f(kernel, threads, smem bytes, tiles) for the kernel that eps and run
// (read up to eps 16) select, or returns -1 when either is beyond the
// kernels' limits.
template <typename T, typename F>
int with_kernel(int nx, int ny, int eps, int run, F f) {
  if (eps < 0 || eps > MAX_EPS) return -1;
  if (eps <= REG_TILES_MAX_EPS)
    return with_eps<REG_TILES_MAX_EPS>(eps, [&](auto e) {
      constexpr int EPS = decltype(e)::value;
      return with_run<T>(run, [&](auto rc) {
        using P = Res2<T, EPS, decltype(rc)::value>;
        const long long tiles =
            static_cast<long long>((nx + P::ROWS - 1) / P::ROWS) * ((ny + P::COLS - 1) / P::COLS);
        return f(resident2d_fast<T, EPS, decltype(rc)::value>, REG_THREADS,
                 2 * P::BUF * sizeof(T), tiles);
      });
    });
  return with_mw(eps, [&](auto mw) {
    const long long tiles =
        static_cast<long long>((nx + TILE_X - 1) / TILE_X) * ((ny + TILE_Y - 1) / TILE_Y);
    return f(resident2d_kernel<T, decltype(mw)::value>, THREADS, tile_smem_bytes<T>(eps), tiles);
  });
}

// The gate at the largest RUN, whose block needs the most registers and
// shared memory: every smaller RUN fits where it does.
template <typename T>
int fits_typed(int nx, int ny, int eps) {
  if (nx <= 0 || ny <= 0) return 0;
  const int blocks = with_kernel<T>(nx, ny, eps, max_run<T>(),
                                    [&](auto kernel, int threads, size_t smem, long long tiles) {
    return resident_blocks(kernel, threads, smem, frame_bytes(nx, ny, eps, sizeof(T)), tiles);
  });
  return blocks > 0 ? blocks : 0;
}

template <typename T>
int launch(void* fa, void* fb, int nx, int ny, int lp, int eps, int nsteps, double scale,
           double wsum, double dt, void* stream) {
  if (nsteps < 0 || lp < ny + 2 * eps || lp % vec_width<T>() != 0) return -1;
  if (reinterpret_cast<uintptr_t>(fa) % 16 != 0 || reinterpret_cast<uintptr_t>(fb) % 16 != 0)
    return -1;
  if (fits_typed<T>(nx, ny, eps) == 0) return -1;
  if (nsteps == 0) return 0;
  T* a = static_cast<T*>(fa);
  T* b = static_cast<T*>(fb);
  T s = static_cast<T>(scale), w = static_cast<T>(wsum), d = static_cast<T>(dt);
  Plan plan = make_plan(eps);
  const int run = pick_run<T>(nx, ny, device_attr(cudaDevAttrMultiProcessorCount));
  return with_kernel<T>(nx, ny, eps, run,
                        [&](auto kernel, int threads, size_t smem, long long tiles) {
    const int blocks =
        resident_blocks(kernel, threads, smem, frame_bytes(nx, ny, eps, sizeof(T)), tiles);
    if (blocks == 0) return -1;
    int ntiles = static_cast<int>(tiles), nty = (ny + 31) / 32;
    void* fast_args[] = {&a, &b, &nx, &ny, &lp, &nty, &ntiles, &nsteps, &s, &w, &d};
    void* body_args[] = {&a, &b, &nx, &ny, &lp, &eps, &nsteps, &plan, &s, &w, &d};
    const cudaError_t e = cudaLaunchCooperativeKernel(
        reinterpret_cast<const void*>(kernel), dim3(blocks), dim3(32, threads / 32),
        eps <= REG_TILES_MAX_EPS ? fast_args : body_args, smem,
        static_cast<cudaStream_t>(stream));
    return static_cast<int>(e != cudaSuccess ? e : cudaGetLastError());
  });
}

}  // namespace

// dtype: 0 = float32, 1 = float64.  fa and fb are (nx+2eps, lp) frames,
// 16-byte aligned, lp >= ny+2eps a multiple of 16 bytes, zero outside the
// interior; fa holds the initial state in its interior.  After the launch
// the state is in fa when nsteps is even, else in fb; the kernel writes the
// interiors only.
extern "C" int nlheat_resident2d(int dtype, void* fa, void* fb, int nx, int ny, int lp, int eps,
                                 int nsteps, double scale, double wsum, double dt,
                                 void* stream) {
  if (dtype == 0) return launch<float>(fa, fb, nx, ny, lp, eps, nsteps, scale, wsum, dt, stream);
  if (dtype == 1) return launch<double>(fa, fb, nx, ny, lp, eps, nsteps, scale, wsum, dt, stream);
  return -1;
}

// The fit gate: the number of co-resident blocks the launch would use at the
// largest run, or 0 when the grid is beyond what the kernel takes on this
// card.
extern "C" int nlheat_resident2d_fits(int dtype, int nx, int ny, int eps) {
  if (dtype == 0) return fits_typed<float>(nx, ny, eps);
  if (dtype == 1) return fits_typed<double>(nx, ny, eps);
  return 0;
}
