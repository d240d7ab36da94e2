// One fused forward-Euler step of B independent 2D solves in one launch, for
// NVIDIA Hopper (sm_90a).
//
// Replaces the Pallas TPU kernel
//   batched_step2d <- nonlocalheatequation_tpu/ops/pallas_kernel.py:
//                     _build_batched_step_kernel
//                     (make_batched_pallas_multi_step_fn, the ensemble
//                     engine's per-step composition)
//
// The case stack is (B, nx, ny), unpadded: out-of-domain window cells are
// loaded as 0 (the volumetric boundary condition), as step2d does.  The
// grid is step2d's 32 x 32 tile lattice with the case index as blockIdx.z,
// and each block runs step2d's tile body (stencil_tile.cuh) on its case's
// plane, so lane b of a launch is bit-identical to one step2d launch on
// case b.
//
// Per-case physics.  The TPU kernel bakes one (scale, dt) pair as
// constants and serves physics-uniform chunks only (a traced scalar changes
// XLA's FMA formation there).  Here the tile body's epilogue rounds every
// multiply and add on its own, so a scalar read from memory gives the same
// bits as one passed by value: each case reads its (scale, dt) from a
// (B, 2) table in the state type, and one launch serves uniform and mixed
// chunks alike.  The test form also reads the case's manufactured-source
// coefficients (coef_g, coef_lg) from a (B, 2) table, a row of a per-run
// table the wrapper's caller builds once on the host in float64 (the same
// source_coefs as step2d) and copies to the card once; nothing is copied
// per step.
//
// What bounds it on an H100 SXM (published peaks, computed, not measured):
// as step2d per case, one state read and one written per step: at
// 8 x 1024^2, eps=8, f32, 2 x 32 MiB, about 20 us, against about 5 us of
// operations (41 adds per point at eps=8, stencil_tile.cuh); the test form
// also reads G and L(G), twice the bytes.
//
// Plain C interface (ops/_build.py, ops/cuda_batched.py): launches on the
// given stream, allocates nothing, returns cudaGetLastError() (0 =
// launched), or -1 when eps, the shared-memory tile, the grid or the case
// count is beyond the kernel's limits.  These limits live here only.

#include "stencil_tile.cuh"

namespace {

using namespace nlheat;

constexpr int MAX_CASES = 65535;  // gridDim.z

template <typename T, typename OpT, int MW>
__global__ void __launch_bounds__(THREADS)
batched_step2d_kernel(const T* __restrict__ u, T* __restrict__ out, int nx, int ny, int eps,
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
  return with_mw(eps, [&](auto mw) {
    auto kernel = batched_step2d_kernel<T, OpT, decltype(mw)::value>;
    const int e = allow_smem(kernel, smem);
    if (e != 0) return e;
    const dim3 block(TILE_Y, THREADS_Y);
    const dim3 grid((ny + TILE_Y - 1) / TILE_Y, (nx + TILE_X - 1) / TILE_X, batch);
    kernel<<<grid, block, smem, static_cast<cudaStream_t>(stream)>>>(
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
