// One forward-Euler step of the 3D state kept in a halo-padded frame, for
// NVIDIA Hopper (sm_90a).
//
// Replaces the Pallas TPU kernel
//   carried3d <- nonlocalheatequation_tpu/ops/pallas_kernel.py:_build_carried_kernel_3d
//                (make_carried_multi_step_fn_3d :1569): the state lives in a
//                padded frame across steps and the kernel re-zeroes the halo.
//
// The frame is (nx + 2eps, ny + 2eps, nz + 2eps) with the state in its
// interior (the TPU kernel's dead bands, which keep its block offsets
// 8-aligned, have no purpose here).  The sums and the epilogue are those of
// the 3D tile bodies (stencil_tile3d.cuh), so a run of carried3d launches is
// bit-identical to the same number of step3d launches.  There is no bf16
// tier (the wrapper refuses a bf16 operator), as on the TPU.
//
// Design, for 0 <= eps <= FAST_MAX_EPS3 (6): step3d's register design
// (stencil_tile3d.cuh, fast3_tile) on a TP x TP x 32 tile lattice aligned to
// the frame's interior, the frame as the source with shift = eps.  Each
// window's z origin is then a multiple of 32 in frame coordinates, so the
// window stages 16 bytes a copy wherever the frame's z extent nz + 2eps is a
// multiple of 16/sizeof(T) and the window line 32 + 2eps too (264 at 256^3
// eps=4 and 140 at 128^3 eps=6 in float32), else 8 bytes where both are
// even in float32, else one cell a copy.  eps
// 7-12: the shared tile body on the same lattice and source.  Either writes
// the interior only: the output frame's halo must already be zero (the
// wrapper zeroes it; the multi-step maker's two frames keep the zero
// halos they were made with).
//
// What bounds it on an H100 SXM (published peaks, computed, not measured):
// the same as step3d, one frame read and one interior written per step
// (about 42 us at 256^3, eps=4, f32: the halo adds (264^3 - 256^3)/256^3 =
// 9.7% to the bytes read), against about the same operations.  Inside the
// SM the shared-memory traffic binds first, as in step3d: about 70 accesses
// per point at eps=4 in the register design, 127 in the tile body.
//
// Plain C interface (ops/_build.py, ops/cuda_kernel3d.py): launches on the
// given stream, allocates nothing, returns cudaGetLastError() or -1 when
// eps, the shared-memory tile or the grid is beyond the kernel's limits.

#include "stencil_tile3d.cuh"

namespace {

using namespace nlheat;

// -- the register design (stencil_tile3d.cuh, fast3_tile), eps 0-6 -----------------

template <typename T, int EPS, int TP>
__global__ void __launch_bounds__(TZ * TP)
carried3d_fast(const T* __restrict__ frame, T* __restrict__ out, const Geom3 g, int chunk,
               T scale, T wsum, T dt) {
  int x0, y0, z0;  // interior coordinates
  tile_origin(g, blockIdx.x, TP, x0, y0, z0);
  T acc[TP];
  const T* win = fast3_tile<T, T, EPS, TP>(frame, g, chunk, x0, y0, z0, acc);

  const int x = x0 + threadIdx.y, z = z0 + threadIdx.x;
  if (x >= g.n[0] || z >= g.n[2]) return;
#pragma unroll
  for (int r = 0; r < TP; ++r) {
    const int y = y0 + r;
    if (y >= g.n[1]) continue;
    const T center = fast3_centre<EPS, TP>(win, r);
    out[(static_cast<size_t>(x + EPS) * g.out[1] + y + EPS) * g.out[2] + z + EPS] =
        euler(center, dt, operator_du(acc[r], center, scale, wsum));
  }
}

template <typename T, int EPS>
int launch_fast(const void* frame, void* out, const int n[3], double scale, double wsum,
                double dt, cudaStream_t stream) {
  constexpr int TP = fast3_tp<T, EPS>();
  const int f[3] = {n[0] + 2 * EPS, n[1] + 2 * EPS, n[2] + 2 * EPS};
  const Geom3 g = interior_geom(f, f, EPS, 0, n, TP);
  return fast3_launch<T, EPS, TP>(carried3d_fast<T, EPS, TP>, g, stream,
                                  static_cast<const T*>(frame), static_cast<T*>(out), g,
                                  fast3_chunk<T, EPS>(g, frame), static_cast<T>(scale),
                                  static_cast<T>(wsum), static_cast<T>(dt));
}

// -- the shared tile body (stencil_tile3d.cuh), eps above FAST_MAX_EPS3 -----------

template <typename T, int TP>
__global__ void __launch_bounds__(THREADS3)
carried3d_kernel(const T* __restrict__ frame, T* __restrict__ out, const Geom3 g, int eps,
                 const Plan3 plan, T scale, T wsum, T dt) {
  constexpr int KP = points_per_thread<TP>();
  extern __shared__ __align__(16) unsigned char smem_raw[];
  const int wp = TP + 2 * eps, wz = TZ + 2 * eps;
  T* win = reinterpret_cast<T*>(smem_raw);
  T* wbuf = win + wp * wp * wz;
  const int tx = threadIdx.x, ty = threadIdx.y;
  int x0, y0, z0;  // interior coordinates
  tile_origin(g, blockIdx.x, TP, x0, y0, z0);

  load_window3<T, T>(win, wp, wz, frame, g, eps, x0, y0, z0);
  __syncthreads();
  T acc[KP];
  window_sums3<T, TP>(win, eps, plan, wbuf, acc);
#pragma unroll
  for (int k = 0; k < KP; ++k) {
    const int p = ty + k * TY3;
    if (p >= TP * TP) continue;
    const int xl = p / TP, yl = p % TP;
    const int x = x0 + xl, y = y0 + yl, z = z0 + tx;
    if (x >= g.n[0] || y >= g.n[1] || z >= g.n[2]) continue;
    const T center = win[((xl + eps) * wp + yl + eps) * wz + tx + eps];
    out[(static_cast<size_t>(x + eps) * g.out[1] + y + eps) * g.out[2] + z + eps] =
        euler(center, dt, operator_du(acc[k], center, scale, wsum));
  }
}

template <typename T>
int launch(const void* frame, void* out, int nx, int ny, int nz, int eps, double scale,
           double wsum, double dt, void* stream) {
  const int tp = tile3_width(eps, sizeof(T));
  if (tp == 0) return -1;
  if (nx <= 0 || ny <= 0 || nz <= 0) return 0;
  const int n[3] = {nx, ny, nz};
  if (eps <= FAST_MAX_EPS3)
    return with_eps<FAST_MAX_EPS3>(eps, [&](auto e) {
      return launch_fast<T, decltype(e)::value>(frame, out, n, scale, wsum, dt,
                                                static_cast<cudaStream_t>(stream));
    });
  return with_tp(tp, [&](auto tpc) {
    constexpr int TP = decltype(tpc)::value;
    const int f[3] = {nx + 2 * eps, ny + 2 * eps, nz + 2 * eps};
    const Geom3 g = interior_geom(f, f, eps, 0, n, TP);
    const long long tiles = tile_count(g);
    if (tiles > INT_MAX) return -1;
    auto kernel = carried3d_kernel<T, TP>;
    const size_t smem = tile3_elems(eps, TP) * sizeof(T);
    const int e = allow_smem(kernel, smem);
    if (e != 0) return e;
    kernel<<<static_cast<unsigned>(tiles), dim3(TZ, TY3), smem,
             static_cast<cudaStream_t>(stream)>>>(
        static_cast<const T*>(frame), static_cast<T*>(out), g, eps, make_plan3(eps),
        static_cast<T>(scale), static_cast<T>(wsum), static_cast<T>(dt));
    return static_cast<int>(cudaGetLastError());
  });
}

}  // namespace

// dtype: 0 = float32, 1 = float64.  frame and out are (nx+2eps, ny+2eps,
// nz+2eps) frames of the state type with the state in the interior; out's
// halo must be zero (the kernel writes the interior only).
extern "C" int nlheat_carried3d(int dtype, const void* frame, void* out, int nx, int ny, int nz,
                                int eps, double scale, double wsum, double dt, void* stream) {
  if (dtype == 0) return launch<float>(frame, out, nx, ny, nz, eps, scale, wsum, dt, stream);
  if (dtype == 1) return launch<double>(frame, out, nx, ny, nz, eps, scale, wsum, dt, stream);
  return -1;
}
