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
// 8-aligned, have no purpose here).  The tiles form a lattice aligned to the
// interior that covers the whole frame: an interior cell gets the step, a
// halo cell gets 0, so the output frame is written whole and may come from
// torch.empty.  A tile that lies wholly in the halo writes its zeros and
// skips the sum.  The tile body (window load, sums, epilogue) is
// stencil_tile3d.cuh's, so a run of carried3d launches is bit-identical to
// the same number of step3d launches.  There is no bf16 tier (the wrapper
// refuses a bf16 operator), as on the TPU.
//
// What bounds it on an H100 SXM (published peaks, computed, not measured):
// the same as step3d, one frame read and one written per step (about 44 us
// at 256^3, eps=4, f32: the halo adds (264^3 - 256^3)/256^3 = 9.7% of bytes
// to the state's 2 x 64 MiB), against about the same operations.
//
// Plain C interface (ops/_build.py, ops/cuda_kernel3d.py): launches on the
// given stream, allocates nothing, returns cudaGetLastError() or -1 when
// eps, the shared-memory tile or the grid is beyond the kernel's limits.

#include "stencil_tile3d.cuh"

namespace {

using namespace nlheat;

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
  int x0, y0, z0;
  tile_origin(g, blockIdx.x, TP, x0, y0, z0);
  const int hi[3] = {g.lo + g.n[0], g.lo + g.n[1], g.lo + g.n[2]};
  const bool halo_only = x0 + TP <= g.lo || x0 >= hi[0] || y0 + TP <= g.lo || y0 >= hi[1] ||
                         z0 + TZ <= g.lo || z0 >= hi[2];  // uniform over the block

  T acc[KP];
  if (!halo_only) {
    load_window3<T, T>(win, wp, wz, frame, g, eps, x0, y0, z0);
    __syncthreads();
    window_sums3<T, TP>(win, eps, plan, wbuf, acc);
  }
#pragma unroll
  for (int k = 0; k < KP; ++k) {
    const int p = ty + k * TY3;
    if (p >= TP * TP) continue;
    const int xl = p / TP, yl = p % TP;
    const int x = x0 + xl, y = y0 + yl, z = z0 + tx;
    if (x < 0 || y < 0 || z < 0 || x >= g.out[0] || y >= g.out[1] || z >= g.out[2]) continue;
    T val = T(0);
    if (!halo_only && x >= g.lo && x < hi[0] && y >= g.lo && y < hi[1] && z >= g.lo &&
        z < hi[2]) {
      const T center = win[((xl + eps) * wp + yl + eps) * wz + tx + eps];
      val = euler(center, dt, operator_du(acc[k], center, scale, wsum));
    }
    out[(static_cast<size_t>(x) * g.out[1] + y) * g.out[2] + z] = val;
  }
}

template <typename T>
int launch(const void* frame, void* out, int nx, int ny, int nz, int eps, double scale,
           double wsum, double dt, void* stream) {
  const int tp = tile3_width(eps, sizeof(T));
  if (tp == 0) return -1;
  if (nx <= 0 || ny <= 0 || nz <= 0) return 0;
  return with_tp(tp, [&](auto tpc) {
    constexpr int TP = decltype(tpc)::value;
    Geom3 g{};
    const int n[3] = {nx, ny, nz};
    const int len[3] = {TP, TP, TZ};
    for (int d = 0; d < 3; ++d) {
      g.out[d] = g.src[d] = n[d] + 2 * eps;
      g.n[d] = n[d];
      const Axis a = axis_aligned(eps, n[d], n[d] + 2 * eps, len[d]);
      g.org[d] = a.org;
      g.tiles[d] = a.count;
    }
    g.shift = 0;
    g.lo = eps;
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
// nz+2eps) frames of the state type with the state in the interior.
extern "C" int nlheat_carried3d(int dtype, const void* frame, void* out, int nx, int ny, int nz,
                                int eps, double scale, double wsum, double dt, void* stream) {
  if (dtype == 0) return launch<float>(frame, out, nx, ny, nz, eps, scale, wsum, dt, stream);
  if (dtype == 1) return launch<double>(frame, out, nx, ny, nz, eps, scale, wsum, dt, stream);
  return -1;
}
