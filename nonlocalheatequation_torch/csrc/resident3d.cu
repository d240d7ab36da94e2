// The whole 3D forward-Euler run in one launch, for NVIDIA Hopper (sm_90a).
//
// Replaces the Pallas TPU kernel
//   resident3d <- nonlocalheatequation_tpu/ops/pallas_kernel.py:_build_resident_kernel_3d
//                 (gate _fits_resident_3d :1401, make_resident_multi_step_fn_3d
//                 :1482): all nsteps steps in one call, the state ping-ponging
//                 between two frames.
//
// The TPU kernel keeps both frames in VMEM.  As resident2d.cu does, this is
// a cooperative persistent kernel instead: the grid is at most as many
// blocks as can be resident on the card at once, each block walks over the
// interior's tiles, and grid.sync() separates the steps.  The two
// (nx + 2eps, ny + 2eps, nz + 2eps) frames with zero halos stay in the 50 MB
// L2 between steps when they fit it (128^3 at eps=6 in f32: two 11.0 MB
// frames), so a step costs no device-memory round trip.  Frame reads go
// through L2 (ld.global.cg), never the read-only path, since other blocks
// wrote them earlier in the same launch.  The tile body is
// stencil_tile3d.cuh's, so the run is bit-identical to nsteps step3d
// launches.
//
// The fit gate is the card's and lives here only: the kernel's block must be
// co-resident at least once per SM, and the two frames must fit in the L2
// (256^3 at eps=4 in f32 needs two 73.6 MB frames: refused).  A grid beyond
// it is refused (-1) before anything is launched.  There is no bf16 tier
// (the wrapper refuses a bf16 operator).
//
// What bounds it on an H100 SXM (published peaks, computed, not measured):
// the state is read once and written once for the whole run, so at 128^3,
// eps=6, f32 the bytes take under 6 us for the run while the operations
// (113 column adds and 75 window-sum adds per point at the 8 x 8 x 32
// tile) take about 6 us per step; a grid-wide barrier per step (a few us,
// not measured) is the cost the design adds.
//
// Plain C interface (ops/_build.py, ops/cuda_kernel3d.py): launches on the
// given stream, allocates nothing, returns the launch status or -1.

#include <cooperative_groups.h>

#include "stencil_tile3d.cuh"

namespace cg = cooperative_groups;

namespace {

using namespace nlheat;

template <typename T, int TP>
__global__ void __launch_bounds__(THREADS3)
resident3d_kernel(T* fa, T* fb, const Geom3 g, int eps, int nsteps, const Plan3 plan, T scale,
                  T wsum, T dt) {
  constexpr int KP = points_per_thread<TP>();
  extern __shared__ __align__(16) unsigned char smem_raw[];
  cg::grid_group grid = cg::this_grid();
  const int wp = TP + 2 * eps, wz = TZ + 2 * eps;
  T* win = reinterpret_cast<T*>(smem_raw);
  T* wbuf = win + wp * wp * wz;
  const int tx = threadIdx.x, ty = threadIdx.y;
  const int ntiles = static_cast<int>(tile_count(g));

  for (int s = 0; s < nsteps; ++s) {
    const T* src = (s & 1) ? fb : fa;
    T* dst = (s & 1) ? fa : fb;
    for (int t = blockIdx.x; t < ntiles; t += gridDim.x) {
      int x0, y0, z0;  // frame coordinates of the tile's first interior cell
      tile_origin(g, t, TP, x0, y0, z0);
      load_window3<T, T, true>(win, wp, wz, src, g, eps, x0, y0, z0);
      __syncthreads();
      T acc[KP];
      window_sums3<T, TP>(win, eps, plan, wbuf, acc);
#pragma unroll
      for (int k = 0; k < KP; ++k) {
        const int p = ty + k * TY3;
        if (p >= TP * TP) continue;
        const int xl = p / TP, yl = p % TP;
        const int x = x0 + xl, y = y0 + yl, z = z0 + tx;
        if (x >= g.lo + g.n[0] || y >= g.lo + g.n[1] || z >= g.lo + g.n[2]) continue;
        const T center = win[((xl + eps) * wp + yl + eps) * wz + tx + eps];
        dst[(static_cast<size_t>(x) * g.out[1] + y) * g.out[2] + z] =
            euler(center, dt, operator_du(acc[k], center, scale, wsum));
      }
      __syncthreads();  // the epilogue's reads of the window are done
    }
    grid.sync();  // the step is written everywhere before the next reads it
  }
}

template <int TP>
Geom3 frame_geom(int nx, int ny, int nz, int eps) {
  const int n[3] = {nx, ny, nz};
  const int f[3] = {nx + 2 * eps, ny + 2 * eps, nz + 2 * eps};
  return interior_geom(f, f, 0, eps, n, TP);
}

// The launch geometry: blocks to launch (co-resident ones only), or 0 when
// the kernel cannot run on this card for this grid.
template <typename T, int TP>
int plan_grid(int nx, int ny, int nz, int eps) {
  if (!device_attr(cudaDevAttrCooperativeLaunch)) return 0;
  const double frames = 2.0 * (nx + 2.0 * eps) * (ny + 2.0 * eps) * (nz + 2.0 * eps) * sizeof(T);
  if (frames > static_cast<double>(device_attr(cudaDevAttrL2CacheSize))) return 0;
  const size_t smem = tile3_elems(eps, TP) * sizeof(T);
  auto kernel = resident3d_kernel<T, TP>;
  if (allow_smem(kernel, smem) != 0) return 0;
  int per_sm = 0;
  if (cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, kernel, THREADS3, smem) !=
      cudaSuccess)
    return 0;
  const long long resident = static_cast<long long>(per_sm) *
                             device_attr(cudaDevAttrMultiProcessorCount);
  const long long ntiles = tile_count(frame_geom<TP>(nx, ny, nz, eps));
  if (ntiles > INT_MAX) return 0;
  return static_cast<int>(ntiles < resident ? ntiles : resident);
}

template <typename T>
int fits_typed(int nx, int ny, int nz, int eps) {
  if (nx <= 0 || ny <= 0 || nz <= 0) return 0;
  const int tp = tile3_width(eps, sizeof(T));
  if (tp == 0) return 0;
  const int blocks = with_tp(tp, [&](auto tpc) {
    return plan_grid<T, decltype(tpc)::value>(nx, ny, nz, eps);
  });
  return blocks > 0 ? blocks : 0;
}

template <typename T>
int launch(void* fa, void* fb, int nx, int ny, int nz, int eps, int nsteps, double scale,
           double wsum, double dt, void* stream) {
  if (nsteps < 0) return -1;
  if (fits_typed<T>(nx, ny, nz, eps) == 0) return -1;
  if (nsteps == 0) return 0;
  return with_tp(tile3_width(eps, sizeof(T)), [&](auto tpc) {
    constexpr int TP = decltype(tpc)::value;
    const int blocks = plan_grid<T, TP>(nx, ny, nz, eps);
    const size_t smem = tile3_elems(eps, TP) * sizeof(T);
    T* a = static_cast<T*>(fa);
    T* b = static_cast<T*>(fb);
    Geom3 g = frame_geom<TP>(nx, ny, nz, eps);
    Plan3 plan = make_plan3(eps);
    T s = static_cast<T>(scale), w = static_cast<T>(wsum), d = static_cast<T>(dt);
    void* args[] = {&a, &b, &g, &eps, &nsteps, &plan, &s, &w, &d};
    const cudaError_t e = cudaLaunchCooperativeKernel(
        reinterpret_cast<const void*>(resident3d_kernel<T, TP>), dim3(blocks), dim3(TZ, TY3),
        args, smem, static_cast<cudaStream_t>(stream));
    return static_cast<int>(e != cudaSuccess ? e : cudaGetLastError());
  });
}

}  // namespace

// dtype: 0 = float32, 1 = float64.  fa and fb are (nx+2eps, ny+2eps,
// nz+2eps) frames with zero halos; fa holds the initial state.  After the
// launch the state is in fa when nsteps is even, else in fb.
extern "C" int nlheat_resident3d(int dtype, void* fa, void* fb, int nx, int ny, int nz, int eps,
                                 int nsteps, double scale, double wsum, double dt,
                                 void* stream) {
  if (dtype == 0)
    return launch<float>(fa, fb, nx, ny, nz, eps, nsteps, scale, wsum, dt, stream);
  if (dtype == 1)
    return launch<double>(fa, fb, nx, ny, nz, eps, nsteps, scale, wsum, dt, stream);
  return -1;
}

// The fit gate: the number of co-resident blocks the launch would use, or 0
// when the grid is beyond what the kernel takes on this card.
extern "C" int nlheat_resident3d_fits(int dtype, int nx, int ny, int nz, int eps) {
  if (dtype == 0) return fits_typed<float>(nx, ny, nz, eps);
  if (dtype == 1) return fits_typed<double>(nx, ny, nz, eps);
  return 0;
}
