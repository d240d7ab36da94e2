// Masked-circle neighbour sum and fused forward-Euler step for the 2D
// nonlocal heat operator, for NVIDIA Hopper (sm_90a).
//
// Replaces two Pallas TPU kernels of nonlocalheatequation_tpu:
//   nsum2d  <- ops/pallas_kernel.py:build_neighbor_sum_2d
//              (the method="pallas" branch of NonlocalOp2D.neighbor_sum_padded)
//   step2d  <- ops/pallas_kernel.py:_build_step_kernel via make_pallas_step_fn
//              (one fused step u + dt*(c*h^2*(sum_circle ubar - Wsum*u) + b_t))
//
// What bounds them on an H100 SXM (NVIDIA's published peaks at the card's
// 700 W limit: 3.35 TB/s HBM3, 67 TFLOP/s f32 outside the tensor cores;
// computed bounds, not measurements): at 4096^2, eps=8, f32 the step reads
// u once and writes the next state once, 2 x 64 MiB, about 40 us; the test
// form also reads G and L(G), 4 x 64 MiB, about 80 us.  The direct sum is
// 197 terms (196 adds) per point, 3.3 G adds per step, about 49 us at the
// f32 peak, which would put the production step above its byte bound; the
// row window sums below cut that to 41 adds per point (about 10 us), so
// both kernels are bound by bytes.
//
// Design.  One block owns a 32 x 32 output tile and stages its
// (32+2eps) x (32+2eps) window in shared memory, reading u from device
// memory about once (the halo overlap of neighbouring tiles is served by
// L2).  The step reads the UNPADDED state: out-of-domain window cells are
// loaded as 0, which is the volumetric boundary condition, so no padded copy
// of the state is made per step.  The window load, the sum (per-row window
// sums: about 2eps+1 + (2eps+1)(32+2eps)/32 shared-memory reads per point
// instead of 197) and the Euler epilogue are the shared tile body of
// stencil_tile.cuh, which the multi-step kernels (carried2d.cu,
// superstep2d.cu, resident2d.cu) include too, so they stay bit-identical
// to step2d.  Types: state float or double, operand the state type or
// __nv_bfloat16.
//
// Plain C interface (loaded with ctypes by ops/_build.py and wrapped in
// ops/cuda_kernel.py).  Each entry point launches on the given stream,
// allocates nothing and returns cudaGetLastError() (0 = launched), or -1
// when eps, the shared-memory tile or the grid is beyond what the kernel
// supports.  These limits live here only; the wrapper turns -1 into a
// ValueError.

#include "stencil_tile.cuh"

namespace {

using namespace nlheat;

enum Mode { NSUM = 0, STEP = 1, STEP_TEST = 2 };

// src is (src_rows, src_cols) row-major; window cell (a, b) of the tile at
// output origin (x0, y0) is src[x0 + a - halo][y0 + b - halo], 0 outside.
// nsum2d passes the halo-padded block with halo = 0; step2d passes the
// unpadded state with halo = eps.
template <typename T, typename OpT, int MW>
__global__ void __launch_bounds__(THREADS)
nlheat2d_kernel(const T* __restrict__ src, int src_rows, int src_cols, int halo,
                T* __restrict__ out, int nx, int ny, int eps, int mode, const Plan plan,
                const T* __restrict__ g, const T* __restrict__ lg,
                T scale, T wsum, T dt, T coef_g, T coef_lg) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  const int wc = TILE_Y + 2 * eps;
  T* tile = reinterpret_cast<T*>(smem_raw);
  T* wbuf = tile + (TILE_X + 2 * eps) * wc;
  const int tx = threadIdx.x, ty = threadIdx.y;
  const int x0 = blockIdx.y * TILE_X, y0 = blockIdx.x * TILE_Y;

  load_window<T, OpT>(tile, wc, TILE_X + 2 * eps, wc, src, src_rows, src_cols, x0 - halo,
                      y0 - halo);
  __syncthreads();
  T acc[ROWS_PER_THREAD];
  window_sums<T, MW>(tile, wc, eps, plan, wbuf, acc);

#pragma unroll
  for (int k = 0; k < ROWS_PER_THREAD; ++k) {
    const int xl = ty + k * THREADS_Y;
    const int x = x0 + xl, y = y0 + tx;
    if (x >= nx || y >= ny) continue;
    const size_t o = static_cast<size_t>(x) * ny + y;
    if (mode == NSUM) {
      out[o] = acc[k];
    } else {
      const T center = tile[(xl + eps) * wc + tx + eps];
      T du = operator_du(acc[k], center, scale, wsum);
      if (mode == STEP_TEST) du = add_source(du, coef_g, g[o], coef_lg, lg[o]);
      const T carry = std::is_same<T, OpT>::value ? center : src[o];
      out[o] = euler(carry, dt, du);
    }
  }
}

template <typename T, typename OpT, int MW>
int launch_mw(const void* src, int src_rows, int src_cols, int halo, void* out, int nx,
              int ny, int eps, int mode, const void* g, const void* lg, double scale,
              double wsum, double dt, double coef_g, double coef_lg, void* stream) {
  const size_t smem = tile_smem_bytes<T>(eps);
  const int e = allow_smem(nlheat2d_kernel<T, OpT, MW>, smem);
  if (e != 0) return e;
  const dim3 block(TILE_Y, THREADS_Y);
  const dim3 grid((ny + TILE_Y - 1) / TILE_Y, (nx + TILE_X - 1) / TILE_X);
  nlheat2d_kernel<T, OpT, MW><<<grid, block, smem, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const T*>(src), src_rows, src_cols, halo, static_cast<T*>(out), nx, ny,
      eps, mode, make_plan(eps), static_cast<const T*>(g), static_cast<const T*>(lg),
      static_cast<T>(scale), static_cast<T>(wsum), static_cast<T>(dt),
      static_cast<T>(coef_g), static_cast<T>(coef_lg));
  return static_cast<int>(cudaGetLastError());
}

template <typename T, typename OpT>
int launch(const void* src, int src_rows, int src_cols, int halo, void* out, int nx, int ny,
           int eps, int mode, const void* g, const void* lg, double scale, double wsum,
           double dt, double coef_g, double coef_lg, void* stream) {
  if (eps < 0 || eps > MAX_EPS) return -1;
  if (tile_smem_bytes<T>(eps) > static_cast<size_t>(smem_limit())) return -1;
  if ((static_cast<long long>(nx) + TILE_X - 1) / TILE_X > 65535) return -1;  // gridDim.y
  if (nx <= 0 || ny <= 0) return 0;
  return with_mw(eps, [&](auto mw) {
    return launch_mw<T, OpT, decltype(mw)::value>(src, src_rows, src_cols, halo, out, nx, ny,
                                                  eps, mode, g, lg, scale, wsum, dt, coef_g,
                                                  coef_lg, stream);
  });
}

template <typename T>
int nsum_typed(int bf16, const void* upad, void* out, int nx, int ny, int eps, void* stream) {
  const int rows = nx + 2 * eps, cols = ny + 2 * eps;
  auto fn = bf16 ? &launch<T, __nv_bfloat16> : &launch<T, T>;
  return fn(upad, rows, cols, 0, out, nx, ny, eps, NSUM, nullptr, nullptr, 0.0, 0.0, 0.0,
            0.0, 0.0, stream);
}

template <typename T>
int step_typed(int bf16, const void* u, void* out, const void* g, const void* lg, int nx,
               int ny, int eps, double scale, double wsum, double dt, double cg, double clg,
               void* stream) {
  auto fn = bf16 ? &launch<T, __nv_bfloat16> : &launch<T, T>;
  return fn(u, nx, ny, eps, out, nx, ny, eps, g != nullptr ? STEP_TEST : STEP, g, lg, scale,
            wsum, dt, cg, clg, stream);
}

}  // namespace

// dtype: 0 = float32, 1 = float64.  bf16: 1 selects the bfloat16 operand tier.
extern "C" int nlheat_nsum2d(int dtype, int bf16, const void* upad, void* out, int nx,
                             int ny, int eps, void* stream) {
  if (dtype == 0) return nsum_typed<float>(bf16, upad, out, nx, ny, eps, stream);
  if (dtype == 1) return nsum_typed<double>(bf16, upad, out, nx, ny, eps, stream);
  return -1;
}

// g == nullptr selects the production form; otherwise g and lg are the
// (nx, ny) manufactured-source profiles and du gains coef_g*G + coef_lg*L(G),
// coef_g = -2*pi*sin(2*pi*t*dt), coef_lg = -cos(2*pi*t*dt) (from the host).
extern "C" int nlheat_step2d(int dtype, int bf16, const void* u, void* out, const void* g,
                             const void* lg, int nx, int ny, int eps, double scale,
                             double wsum, double dt, double coef_g, double coef_lg,
                             void* stream) {
  if (dtype == 0)
    return step_typed<float>(bf16, u, out, g, lg, nx, ny, eps, scale, wsum, dt, coef_g,
                             coef_lg, stream);
  if (dtype == 1)
    return step_typed<double>(bf16, u, out, g, lg, nx, ny, eps, scale, wsum, dt, coef_g,
                              coef_lg, stream);
  return -1;
}

