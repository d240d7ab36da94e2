// Masked-sphere neighbour sum and fused forward-Euler step for the 3D
// nonlocal heat operator, for NVIDIA Hopper (sm_90a).
//
// Replaces the Pallas TPU kernel of nonlocalheatequation_tpu
//   nsum3d  <- ops/pallas_kernel.py:build_neighbor_sum_3d (body
//              _block_neighbor_sum_3d :672): the method="pallas" branch of
//              NonlocalOp3D.neighbor_sum_padded
// and fuses it, in step3d, with the Euler epilogue that XLA fuses outside
// the TPU kernel (the generic step, ops/nonlocal_op.py:519-530):
//   production  u + dt*(scale*(nsum - wsum*u))
//   test form   u + dt*((scale*(nsum - wsum*u)) + (coef_g*G + coef_lg*L(G)))
//
// What bounds them on an H100 SXM (NVIDIA's published peaks at the card's
// 700 W limit: 3.35 TB/s HBM3, 67 TFLOP/s f32 outside the tensor cores;
// computed bounds, not measurements): at 256^3, eps=4, f32 the step reads u
// once and writes the next state once, 2 x 64 MiB, about 40 us.  The direct
// sum is 256 adds per point, 4.3 G adds per step, about 64 us at the f32
// peak, above the byte bound; the z window sums cut that to 49 column adds
// plus about 23 window-sum adds per point at the 8 x 8 x 32 tile.  Inside
// the SM the shared-memory traffic binds first: about 127 accesses per
// point in the tile body (stencil_tile3d.cuh), with which step3d took
// 0.5047 ms, 12.6x the byte bound (H100 80GB HBM3 at 700 W, PERF.md).
//
// The order of the adds (the contract shared with stencil_tile3d.cuh, whose
// body carried3d, resident3d, split_nsum3d and fused_nsum3d run, and with
// the plain versions' sphere_sum, ops/cuda_kernel.py):
//   1. every window line's z sums W_0 = line[0], W_h = (W_{h-1} + line[-h])
//      + line[+h], one pair of cells per height h;
//   2. each output starts from 0 and adds W_{h(i,j)} of the window line at
//      plane offset (i, j) over the sphere's columns, heights ascending, then
//      (i, j) ascending within a height;
//   3. the epilogue u + dt*(scale*(nsum - wsum*u) [+ (cg*G + clg*L(G))]), every
//      multiply and add rounded on its own (stencil_tile.cuh).
//
// Design, for 0 <= eps <= FAST_MAX_EPS3 (6): the register design of
// stencil_tile3d.cuh (fast3_tile, which carried3d.cu runs too): a block of
// 32 x TP threads owns a TP x TP x 32 output tile, stages its window by
// cp.async (16 bytes a copy where the source's rows and the window's z
// origin are aligned: nz a multiple of 4 at eps 0 and 4 in float32, as the
// 256^3 eps=4 step; 8 bytes where they fall on 8-byte boundaries, as nz even
// at eps 2 and 6 in float32), and keeps W_h of its window lines in registers, one
// barrier a height: about 70 shared-memory accesses per point at eps=4, f32,
// against the tile body's 127.  In the bf16 tier the block rounds its staged
// window in place once.
//
// eps 7-12 run the shared tile body (stencil_tile3d.cuh), which gives the
// same bits.  Types: state float or double, operand the state type or
// __nv_bfloat16.  The step reads the UNPADDED state (zeros outside the
// domain, the volumetric boundary condition), so no padded copy of the
// state is made per step.

// Plain C interface (loaded with ctypes by ops/_build.py and wrapped in
// ops/cuda_kernel3d.py).  Each entry point launches on the given stream,
// allocates nothing and returns cudaGetLastError() (0 = launched), or -1
// when eps, the shared-memory tile or the grid is beyond what the kernel
// supports.  These limits live here only; the wrapper turns -1 into a
// ValueError.

#include "stencil_tile3d.cuh"

namespace {

using namespace nlheat;

enum Mode { NSUM = 0, STEP = 1, STEP_TEST = 2 };

// -- the register design (stencil_tile3d.cuh, fast3_tile), eps 0-6 -----------------

template <typename T, typename OpT, int EPS, int TP>
__global__ void __launch_bounds__(TZ * TP)
nlheat3d_fast(const T* __restrict__ src, T* __restrict__ out, const Geom3 g, int chunk, int mode,
              const T* __restrict__ gsrc, const T* __restrict__ lgsrc, T scale, T wsum, T dt,
              T coef_g, T coef_lg) {
  int x0, y0, z0;
  tile_origin(g, blockIdx.x, TP, x0, y0, z0);
  T acc[TP];
  const T* win = fast3_tile<T, OpT, EPS, TP>(src, g, chunk, x0, y0, z0, acc);

  // step 3
  const int x = x0 + threadIdx.y, z = z0 + threadIdx.x;
  if (x >= g.out[0] || z >= g.out[2]) return;
#pragma unroll
  for (int r = 0; r < TP; ++r) {
    const int y = y0 + r;
    if (y >= g.out[1]) continue;
    const size_t o = (static_cast<size_t>(x) * g.out[1] + y) * g.out[2] + z;
    if (mode == NSUM) {
      out[o] = acc[r];
    } else {
      const T center = fast3_centre<EPS, TP>(win, r);
      T du = operator_du(acc[r], center, scale, wsum);
      if (mode == STEP_TEST)
        du = add_rn(du, add_rn(mul_rn(coef_g, gsrc[o]), mul_rn(coef_lg, lgsrc[o])));
      const T carry = std::is_same<T, OpT>::value ? center : src[o];
      out[o] = euler(carry, dt, du);
    }
  }
}

template <typename T, typename OpT, int EPS>
int launch_fast(const void* src, const int sdim[3], int shift, void* out, const int n[3],
                int mode, const void* g, const void* lg, double scale, double wsum, double dt,
                double coef_g, double coef_lg, cudaStream_t stream) {
  constexpr int TP = fast3_tp<T, EPS>();
  const Geom3 geom = interior_geom(n, sdim, shift, 0, n, TP);
  return fast3_launch<T, EPS, TP>(
      nlheat3d_fast<T, OpT, EPS, TP>, geom, stream, static_cast<const T*>(src),
      static_cast<T*>(out), geom, fast3_chunk<T, EPS>(geom, src), mode, static_cast<const T*>(g),
      static_cast<const T*>(lg), static_cast<T>(scale), static_cast<T>(wsum),
      static_cast<T>(dt), static_cast<T>(coef_g), static_cast<T>(coef_lg));
}

// -- the shared tile body (stencil_tile3d.cuh), eps above FAST_MAX_EPS3 -----------

template <typename T, typename OpT, int TP>
__global__ void __launch_bounds__(THREADS3)
nlheat3d_kernel(const T* __restrict__ src, T* __restrict__ out, const Geom3 g, int eps,
                int mode, const Plan3 plan, const T* __restrict__ gsrc,
                const T* __restrict__ lgsrc, T scale, T wsum, T dt, T coef_g, T coef_lg) {
  constexpr int KP = points_per_thread<TP>();
  extern __shared__ __align__(16) unsigned char smem_raw[];
  const int wp = TP + 2 * eps, wz = TZ + 2 * eps;
  T* win = reinterpret_cast<T*>(smem_raw);
  T* wbuf = win + wp * wp * wz;
  const int tx = threadIdx.x, ty = threadIdx.y;
  int x0, y0, z0;
  tile_origin(g, blockIdx.x, TP, x0, y0, z0);

  load_window3<T, OpT>(win, wp, wz, src, g, eps, x0, y0, z0);
  __syncthreads();
  T acc[KP];
  window_sums3<T, TP>(win, eps, plan, wbuf, acc);

#pragma unroll
  for (int k = 0; k < KP; ++k) {
    const int p = ty + k * TY3;
    if (p >= TP * TP) continue;
    const int xl = p / TP, yl = p % TP;
    const int x = x0 + xl, y = y0 + yl, z = z0 + tx;
    if (x >= g.out[0] || y >= g.out[1] || z >= g.out[2]) continue;
    const size_t o = (static_cast<size_t>(x) * g.out[1] + y) * g.out[2] + z;
    if (mode == NSUM) {
      out[o] = acc[k];
    } else {
      const T center = win[((xl + eps) * wp + yl + eps) * wz + tx + eps];
      T du = operator_du(acc[k], center, scale, wsum);
      if (mode == STEP_TEST)
        du = add_rn(du, add_rn(mul_rn(coef_g, gsrc[o]), mul_rn(coef_lg, lgsrc[o])));
      const T carry = std::is_same<T, OpT>::value ? center : src[o];
      out[o] = euler(carry, dt, du);
    }
  }
}

template <typename T, typename OpT>
int launch(const void* src, const int sdim[3], int shift, void* out, const int n[3], int eps,
           int mode, const void* g, const void* lg, double scale, double wsum, double dt,
           double coef_g, double coef_lg, void* stream) {
  const int tp = tile3_width(eps, sizeof(T));
  if (tp == 0) return -1;
  if (n[0] <= 0 || n[1] <= 0 || n[2] <= 0) return 0;
  if (eps <= FAST_MAX_EPS3)
    return with_eps<FAST_MAX_EPS3>(eps, [&](auto e) {
      return launch_fast<T, OpT, decltype(e)::value>(src, sdim, shift, out, n, mode, g, lg,
                                                     scale, wsum, dt, coef_g, coef_lg,
                                                     static_cast<cudaStream_t>(stream));
    });
  return with_tp(tp, [&](auto tpc) {
    constexpr int TP = decltype(tpc)::value;
    const Geom3 geom = interior_geom(n, sdim, shift, 0, n, TP);
    const long long tiles = tile_count(geom);
    if (tiles > INT_MAX) return -1;
    auto kernel = nlheat3d_kernel<T, OpT, TP>;
    const size_t smem = tile3_elems(eps, TP) * sizeof(T);
    const int e = allow_smem(kernel, smem);
    if (e != 0) return e;
    kernel<<<static_cast<unsigned>(tiles), dim3(TZ, TY3), smem,
             static_cast<cudaStream_t>(stream)>>>(
        static_cast<const T*>(src), static_cast<T*>(out), geom, eps, mode, make_plan3(eps),
        static_cast<const T*>(g), static_cast<const T*>(lg), static_cast<T>(scale),
        static_cast<T>(wsum), static_cast<T>(dt), static_cast<T>(coef_g),
        static_cast<T>(coef_lg));
    return static_cast<int>(cudaGetLastError());
  });
}

template <typename T>
int nsum_typed(int bf16, const void* upad, void* out, int nx, int ny, int nz, int eps,
               void* stream) {
  const int n[3] = {nx, ny, nz};
  const int sdim[3] = {nx + 2 * eps, ny + 2 * eps, nz + 2 * eps};
  auto fn = bf16 ? &launch<T, __nv_bfloat16> : &launch<T, T>;
  return fn(upad, sdim, eps, out, n, eps, NSUM, nullptr, nullptr, 0.0, 0.0, 0.0, 0.0, 0.0,
            stream);
}

template <typename T>
int step_typed(int bf16, const void* u, void* out, const void* g, const void* lg, int nx,
               int ny, int nz, int eps, double scale, double wsum, double dt, double cg,
               double clg, void* stream) {
  const int n[3] = {nx, ny, nz};
  auto fn = bf16 ? &launch<T, __nv_bfloat16> : &launch<T, T>;
  return fn(u, n, 0, out, n, eps, g != nullptr ? STEP_TEST : STEP, g, lg, scale, wsum, dt, cg,
            clg, stream);
}

}  // namespace

// dtype: 0 = float32, 1 = float64.  bf16: 1 selects the bfloat16 operand tier.
// upad is the (nx+2eps, ny+2eps, nz+2eps) halo-padded block, out (nx, ny, nz).
extern "C" int nlheat_nsum3d(int dtype, int bf16, const void* upad, void* out, int nx, int ny,
                             int nz, int eps, void* stream) {
  if (dtype == 0) return nsum_typed<float>(bf16, upad, out, nx, ny, nz, eps, stream);
  if (dtype == 1) return nsum_typed<double>(bf16, upad, out, nx, ny, nz, eps, stream);
  return -1;
}

// g == nullptr selects the production form; otherwise g and lg are the
// (nx, ny, nz) manufactured-source profiles and du gains
// coef_g*G + coef_lg*L(G), coef_g = -2*pi*sin(2*pi*t*dt),
// coef_lg = -cos(2*pi*t*dt) (from the host).
extern "C" int nlheat_step3d(int dtype, int bf16, const void* u, void* out, const void* g,
                             const void* lg, int nx, int ny, int nz, int eps, double scale,
                             double wsum, double dt, double coef_g, double coef_lg,
                             void* stream) {
  if (dtype == 0)
    return step_typed<float>(bf16, u, out, g, lg, nx, ny, nz, eps, scale, wsum, dt, coef_g,
                             coef_lg, stream);
  if (dtype == 1)
    return step_typed<double>(bf16, u, out, g, lg, nx, ny, nz, eps, scale, wsum, dt, coef_g,
                              coef_lg, stream);
  return -1;
}

// The plane width of the 3D tile body's tiles for this dtype and eps (8, 4,
// 2 or 1; the register design below eps 7 sizes its own), or 0 when the
// kernels refuse eps.
extern "C" int nlheat_tile3d(int dtype, int eps) {
  if (dtype == 0) return tile3_width(eps, sizeof(float));
  if (dtype == 1) return tile3_width(eps, sizeof(double));
  return 0;
}
