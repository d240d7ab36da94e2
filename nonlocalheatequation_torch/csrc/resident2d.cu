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
// (cudaOccupancyMaxActiveBlocksPerMultiprocessor x SMs), each block walks
// over 32 x 32 output tiles, and grid.sync() separates the steps.  The two
// (nx + 2eps, ny + 2eps) frames with zero halos are small enough to stay in
// the 50 MB L2 between steps, so a step costs no device-memory round trip
// in the regime the kernel is for (the reference's 100^2-400^2 grids, where
// one launch per step costs more than the step).  Frame reads go through L2
// (ld.global.cg), never the read-only path, since other blocks wrote them
// earlier in the same launch.  The tile body is stencil_tile.cuh's, so the
// run is bit-identical to nsteps step2d launches.
//
// The fit gate is the card's and lives here only: the kernel's block must
// be co-resident at least once per SM, and the two frames must fit in the
// L2.  A grid beyond it is refused (-1) before anything is launched.
// There is no bf16 tier (the wrapper refuses a bf16 operator).
//
// What bounds it on an H100 SXM (published peaks, computed, not measured):
// the state is read once and written once for the whole run, so at 512^2,
// eps=8, f32 the bytes take under 1 us while the operations take about
// 0.2 us per step; a grid-wide barrier per step (a few us, not measured)
// is the cost the design adds.
//
// Plain C interface (ops/_build.py, ops/cuda_kernel.py): launches on the
// given stream, allocates nothing, returns the launch status or -1.

#include <cooperative_groups.h>

#include "stencil_tile.cuh"

namespace cg = cooperative_groups;

namespace {

using namespace nlheat;

template <typename T, int MW>
__global__ void __launch_bounds__(THREADS)
resident2d_kernel(T* fa, T* fb, int nx, int ny, int eps, int nsteps, const Plan plan, T scale,
                  T wsum, T dt) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  cg::grid_group grid = cg::this_grid();
  const int R = nx + 2 * eps, L = ny + 2 * eps;
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
      load_window<T, T, true>(tile, wc, TILE_X + 2 * eps, wc, src, R, L, x0, y0);
      __syncthreads();
      T acc[ROWS_PER_THREAD];
      window_sums<T, MW>(tile, wc, eps, plan, wbuf, acc);
#pragma unroll
      for (int k = 0; k < ROWS_PER_THREAD; ++k) {
        const int xl = ty + k * THREADS_Y;
        const int x = x0 + xl, y = y0 + tx;
        if (x >= nx || y >= ny) continue;
        const T center = tile[(xl + eps) * wc + tx + eps];
        dst[static_cast<size_t>(x + eps) * L + y + eps] =
            euler(center, dt, operator_du(acc[k], center, scale, wsum));
      }
      __syncthreads();  // the epilogue's reads of the tile are done
    }
    grid.sync();  // the step is written everywhere before the next reads it
  }
}

// The launch geometry: blocks to launch (co-resident ones only), or 0 when
// the kernel cannot run on this card for this grid.
template <typename T, int MW>
int plan_grid(int nx, int ny, int eps, size_t smem) {
  if (!device_attr(cudaDevAttrCooperativeLaunch)) return 0;
  const double frames = 2.0 * (nx + 2.0 * eps) * (ny + 2.0 * eps) * sizeof(T);
  if (frames > static_cast<double>(device_attr(cudaDevAttrL2CacheSize))) return 0;
  if (smem > static_cast<size_t>(smem_limit())) return 0;
  auto kernel = resident2d_kernel<T, MW>;
  if (allow_smem(kernel, smem) != 0) return 0;
  int per_sm = 0;
  if (cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, kernel, THREADS, smem) !=
      cudaSuccess)
    return 0;
  const long long resident = static_cast<long long>(per_sm) *
                             device_attr(cudaDevAttrMultiProcessorCount);
  const long long ntiles = static_cast<long long>((nx + TILE_X - 1) / TILE_X) *
                           ((ny + TILE_Y - 1) / TILE_Y);
  return static_cast<int>(ntiles < resident ? ntiles : resident);
}

template <typename T>
int fits_typed(int nx, int ny, int eps) {
  if (eps < 0 || eps > MAX_EPS || nx <= 0 || ny <= 0) return 0;
  return with_mw(eps, [&](auto mw) {
    return plan_grid<T, decltype(mw)::value>(nx, ny, eps, tile_smem_bytes<T>(eps));
  });
}

template <typename T>
int launch(void* fa, void* fb, int nx, int ny, int eps, int nsteps, double scale, double wsum,
           double dt, void* stream) {
  if (nsteps < 0) return -1;
  if (fits_typed<T>(nx, ny, eps) == 0) return -1;
  if (nsteps == 0) return 0;
  return with_mw(eps, [&](auto mw) {
    constexpr int MW = decltype(mw)::value;
    const size_t smem = tile_smem_bytes<T>(eps);
    const int blocks = plan_grid<T, MW>(nx, ny, eps, smem);
    T* a = static_cast<T*>(fa);
    T* b = static_cast<T*>(fb);
    Plan plan = make_plan(eps);
    T s = static_cast<T>(scale), w = static_cast<T>(wsum), d = static_cast<T>(dt);
    void* args[] = {&a, &b, &nx, &ny, &eps, &nsteps, &plan, &s, &w, &d};
    const cudaError_t e = cudaLaunchCooperativeKernel(
        reinterpret_cast<const void*>(resident2d_kernel<T, MW>), dim3(blocks),
        dim3(TILE_Y, THREADS_Y), args, smem, static_cast<cudaStream_t>(stream));
    return static_cast<int>(e != cudaSuccess ? e : cudaGetLastError());
  });
}

}  // namespace

// dtype: 0 = float32, 1 = float64.  fa and fb are (nx+2eps, ny+2eps) frames
// with zero halos; fa holds the initial state.  After the launch the state
// is in fa when nsteps is even, else in fb.
extern "C" int nlheat_resident2d(int dtype, void* fa, void* fb, int nx, int ny, int eps,
                                 int nsteps, double scale, double wsum, double dt,
                                 void* stream) {
  if (dtype == 0) return launch<float>(fa, fb, nx, ny, eps, nsteps, scale, wsum, dt, stream);
  if (dtype == 1) return launch<double>(fa, fb, nx, ny, eps, nsteps, scale, wsum, dt, stream);
  return -1;
}

// The fit gate: the number of co-resident blocks the launch would use, or 0
// when the grid is beyond what the kernel takes on this card.
extern "C" int nlheat_resident2d_fits(int dtype, int nx, int ny, int eps) {
  if (dtype == 0) return fits_typed<float>(nx, ny, eps);
  if (dtype == 1) return fits_typed<double>(nx, ny, eps);
  return 0;
}
