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
// (nx + 2eps, ny + 2eps, zp) frames with zero halos stay in the 50 MB L2
// between steps when they fit it (128^3 at eps=6 in f32: two 11.0 MB
// frames), so a step costs no device-memory round trip.  zp is the z
// extent nz + 2eps padded to a multiple of 16 bytes (the wrapper allocates
// the frames and keeps the padding zero).
//
// Design, for 0 <= eps <= FAST_MAX_EPS3 (6): each step is carried3d's
// (stencil_tile3d.cuh, fast3_sums): a TP x TP x 32 tile lattice aligned to
// the interior, the source frame read at shift eps, the window staged by
// cp.async and summed with the W values in registers, the epilogue writing
// the other frame's interior.  Every copy is cp.async.cg of 16 bytes, which
// reads through L2 and never L1 (other blocks wrote the frame earlier in the
// same launch): the window's z origin is a multiple of 32 in frame
// coordinates, zp is whole copies, and the window line is padded to whole
// copies (line16: 36 cells at eps=1 in f32), its extra cells staged and
// never summed.  Nothing else reads a frame in device memory (the centre
// comes from the staged window).  eps 7-12: the shared tile body on the
// frame's interior, its loads ld.global.cg (load_window3<..., true>).  Both
// add in the tile body's order, so the run is bit-identical to nsteps step3d
// launches.
//
// The fit gate is the card's and lives here only: the kernel's block must be
// co-resident at least once per SM, and the two unpadded frames must fit in
// the L2 (256^3 at eps=4 in f32 needs two 73.6 MB frames: refused).  A grid
// beyond it is refused (-1) before anything is launched.  There is no bf16
// tier (the wrapper refuses a bf16 operator).
//
// What bounds it on an H100 SXM (published peaks, computed, not measured):
// the state is read once and written once for the whole run, so at 128^3,
// eps=6, f32 the bytes take under 6 us for the run while the operations
// (113 column adds and 75 window-sum adds per point at the 8 x 8 x 32
// tile) take about 6 us per step.  Inside the SM the W buffers' shared-
// memory traffic binds first, as in carried3d (about 70 accesses a point),
// and the grid-wide barrier a step is the cost the design adds.  Measured
// (chip_smoke.py --ab, NVIDIA H100 80GB HBM3, 700.00 W, PERF.md section 6):
// a 20-step launch at 128^3, eps=6, f32 takes 1.73 ms (the earlier tile body:
// 4.30), 0.086 ms a step against carried3d's 0.089 a launch in a CUDA
// graph; the barrier is about 2 us of it.
//
// Plain C interface (ops/_build.py, ops/cuda_kernel3d.py): launches on the
// given stream, allocates nothing, returns the launch status or -1.

#include <cooperative_groups.h>

#include <cstdint>

#include "stencil_tile3d.cuh"

namespace cg = cooperative_groups;

namespace {

using namespace nlheat;

// -- the register design (stencil_tile3d.cuh, fast3_sums), eps 0-6 -----------------

template <typename T, int EPS>
struct Resident3 {
  static constexpr int LP = line16<T, EPS>();     // the staged line, whole 16-byte copies
  static constexpr int TP = fast3_tp<T, EPS, LP>();
  static_assert(TP > 0, "every eps of the register design fits a block");
};

template <typename T, int EPS>
__global__ void __launch_bounds__(TZ * Resident3<T, EPS>::TP)
resident3d_fast(T* fa, T* fb, const Geom3 g, int nsteps, T scale, T wsum, T dt) {
  constexpr int LP = Resident3<T, EPS>::LP, TP = Resident3<T, EPS>::TP;
  cg::grid_group grid = cg::this_grid();
  const int ntiles = static_cast<int>(tile_count(g));
  const Span3 span = whole_source(g);

  for (int s = 0; s < nsteps; ++s) {
    const T* src = (s & 1) ? fb : fa;
    T* dst = (s & 1) ? fa : fb;
    for (int t = blockIdx.x; t < ntiles; t += gridDim.x) {
      int x0, y0, z0;  // interior coordinates
      tile_origin(g, t, TP, x0, y0, z0);
      T acc[TP];
      const T* win = fast3_sums<T, T, EPS, TP, LP>(
          [&](T* w) {
            fast3_stage_chunks<T, EPS, TP, vec_width<T>(), LP>(w, src, g, span, x0, y0, z0);
          },
          acc);
      const int x = x0 + threadIdx.y, z = z0 + threadIdx.x;
      if (x < g.n[0] && z < g.n[2]) {
#pragma unroll
        for (int r = 0; r < TP; ++r) {
          const int y = y0 + r;
          if (y >= g.n[1]) continue;
          const T center = fast3_centre<EPS, TP, LP>(win, r);
          dst[(static_cast<size_t>(x + EPS) * g.out[1] + y + EPS) * g.out[2] + z + EPS] =
              euler(center, dt, operator_du(acc[r], center, scale, wsum));
        }
      }
      __syncthreads();  // the epilogue's reads of the window are done before the next stage
    }
    if (s + 1 < nsteps) grid.sync();  // the step is written everywhere before the next reads it
  }
}

// -- the shared tile body (stencil_tile3d.cuh), eps above FAST_MAX_EPS3 -----------

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
    if (s + 1 < nsteps) grid.sync();  // the step is written everywhere before the next reads it
  }
}

// The frames' geometry: the interior tiled from interior coordinate 0 and
// read at shift eps (the register design), or tiled from frame coordinate
// eps and read at shift 0 (the tile body).
Geom3 frame_geom(int nx, int ny, int nz, int zp, int eps, bool fast, int tp) {
  const int n[3] = {nx, ny, nz};
  const int f[3] = {nx + 2 * eps, ny + 2 * eps, zp};
  return fast ? interior_geom(f, f, eps, 0, n, tp) : interior_geom(f, f, 0, eps, n, tp);
}

double frame_bytes(int nx, int ny, int nz, int eps, size_t elem) {
  return (nx + 2.0 * eps) * (ny + 2.0 * eps) * (nz + 2.0 * eps) * elem;
}

// Calls f(kernel, threads, smem bytes, geometry) for the kernel eps runs on
// this card, or returns -1 when eps is beyond the kernels' limits.
template <typename T, typename F>
int with_kernel(int nx, int ny, int nz, int zp, int eps, F f) {
  if (eps >= 0 && eps <= FAST_MAX_EPS3)
    return with_eps<FAST_MAX_EPS3>(eps, [&](auto e) {
      constexpr int EPS = decltype(e)::value, TP = Resident3<T, EPS>::TP;
      return f(resident3d_fast<T, EPS>, TZ * TP,
               fast3_elems(EPS, TP, Resident3<T, EPS>::LP) * sizeof(T),
               frame_geom(nx, ny, nz, zp, EPS, true, TP));
    });
  const int tp = tile3_width(eps, sizeof(T));
  if (tp == 0) return -1;
  return with_tp(tp, [&](auto tpc) {
    constexpr int TP = decltype(tpc)::value;
    return f(resident3d_kernel<T, TP>, THREADS3, tile3_elems(eps, TP) * sizeof(T),
             frame_geom(nx, ny, nz, zp, eps, false, TP));
  });
}

template <typename T>
int fits_typed(int nx, int ny, int nz, int eps) {
  if (nx <= 0 || ny <= 0 || nz <= 0) return 0;
  const int blocks = with_kernel<T>(nx, ny, nz, nz + 2 * eps, eps,
                                    [&](auto kernel, int threads, size_t smem, const Geom3& g) {
    return resident_blocks(kernel, threads, smem, frame_bytes(nx, ny, nz, eps, sizeof(T)),
                           tile_count(g));
  });
  return blocks > 0 ? blocks : 0;
}

template <typename T>
int launch(void* fa, void* fb, int nx, int ny, int nz, int zp, int eps, int nsteps,
           double scale, double wsum, double dt, void* stream) {
  constexpr int V = vec_width<T>();
  if (nsteps < 0 || zp < nz + 2 * eps || zp % V != 0) return -1;
  if (reinterpret_cast<uintptr_t>(fa) % 16 != 0 || reinterpret_cast<uintptr_t>(fb) % 16 != 0)
    return -1;
  if (fits_typed<T>(nx, ny, nz, eps) == 0) return -1;
  if (nsteps == 0) return 0;
  T* a = static_cast<T*>(fa);
  T* b = static_cast<T*>(fb);
  T s = static_cast<T>(scale), w = static_cast<T>(wsum), d = static_cast<T>(dt);
  Plan3 plan = make_plan3(eps);
  return with_kernel<T>(nx, ny, nz, zp, eps,
                        [&](auto kernel, int threads, size_t smem, Geom3 g) {
    const int blocks = resident_blocks(kernel, threads, smem,
                                       frame_bytes(nx, ny, nz, eps, sizeof(T)), tile_count(g));
    if (blocks == 0) return -1;
    void* fast_args[] = {&a, &b, &g, &nsteps, &s, &w, &d};
    void* body_args[] = {&a, &b, &g, &eps, &nsteps, &plan, &s, &w, &d};
    const cudaError_t e = cudaLaunchCooperativeKernel(
        reinterpret_cast<const void*>(kernel), dim3(blocks), dim3(TZ, threads / TZ),
        eps <= FAST_MAX_EPS3 ? fast_args : body_args, smem, static_cast<cudaStream_t>(stream));
    return static_cast<int>(e != cudaSuccess ? e : cudaGetLastError());
  });
}

}  // namespace

// dtype: 0 = float32, 1 = float64.  fa and fb are (nx+2eps, ny+2eps, zp)
// frames, 16-byte aligned, zp >= nz+2eps a multiple of 16 bytes, zero
// outside the interior; fa holds the initial state in its interior.  After
// the launch the state is in fa when nsteps is even, else in fb; the kernel
// writes the interiors only.
extern "C" int nlheat_resident3d(int dtype, void* fa, void* fb, int nx, int ny, int nz, int zp,
                                 int eps, int nsteps, double scale, double wsum, double dt,
                                 void* stream) {
  if (dtype == 0)
    return launch<float>(fa, fb, nx, ny, nz, zp, eps, nsteps, scale, wsum, dt, stream);
  if (dtype == 1)
    return launch<double>(fa, fb, nx, ny, nz, zp, eps, nsteps, scale, wsum, dt, stream);
  return -1;
}

// The fit gate: the number of co-resident blocks the launch would use, or 0
// when the grid is beyond what the kernel takes on this card.
extern "C" int nlheat_resident3d_fits(int dtype, int nx, int ny, int nz, int eps) {
  if (dtype == 0) return fits_typed<float>(nx, ny, nz, eps);
  if (dtype == 1) return fits_typed<double>(nx, ny, nz, eps);
  return 0;
}
