// K forward-Euler steps of B independent 2D solves per launch, by
// trapezoidal temporal blocking, for NVIDIA Hopper (sm_90a).
//
// Replaces the Pallas TPU kernel
//   batched_superstep2d <- nonlocalheatequation_tpu/ops/pallas_kernel.py:
//                          _build_batched_superstep_kernel
//                          (make_batched_superstep_multi_step_fn)
//
// The stack is (B, nx, ny), unpadded.  The grid is superstep2d's lattice of
// OT x OT output tiles over one plane with the case index as blockIdx.z,
// and each block runs superstep2d's levels on its case's plane: the very
// __device__ bodies of stencil_tile.cuh that superstep2d.cu's kernels call
// (superstep_levels, the register design, for 0 <= eps <= 8;
// superstep_tile_levels, the shared tile body, above), with the same output
// tile side for the same eps, K, type and tier.  Same levels, masks and
// order per case, so lane b is bit-identical to one superstep2d launch of
// the same K on case b, hence to K step2d launches and to
// batched_superstep2d_plain (ops/cuda_batched.py).
//
// Design, for eps <= SUPERSTEP_FAST_MAX_EPS (8): the register design of
// superstep2d.cu.  The window widened by K*eps per side is staged by
// cp.async (cells outside the plane zero-filled by the copy); each level's
// band is cut into items of 32 columns by RUN rows dealt over the warps, a
// thread keeping W_h of its column's RUN + 2eps window rows in registers
// (register_sums); no barrier inside a level, one between levels; no sum
// buffer, and no operand buffer in the bf16 tier (register_sums and the
// operator's centre round each cell they read, the carry reads the
// unrounded state).  Four warps a block, six where the shared memory admits
// just two blocks an SM (superstep_launch).  Above eps 8 the shared tile
// body, as before.
//
// Per-case physics: each case reads its (scale, dt) from a (B, 2) table in
// the state type (see batched_step2d.cu), and one launch serves uniform and
// mixed chunks alike.  Production form only.
//
// What bounds it on an H100 SXM (published peaks, computed, not measured):
// one stack read and one written per launch (about 20 us at 8 x 1024^2,
// eps=8, f32), against K times the step's operations (about 5 us each)
// plus the redundant bands (1.63x at K=2, 1.83x at K=3 with OT = 64).
// Inside the SM the levels' shared-memory reads bind first, as in
// superstep2d: about 26 a point a level at eps=8, f32.
//
// Plain C interface (ops/_build.py, ops/cuda_batched.py): launches on the
// given stream, allocates nothing, returns cudaGetLastError() or -1 when K,
// eps, the shared memory, the grid or the case count is beyond the
// kernel's limits.  nlheat_batched_superstep2d_fits is the fit gate: the
// output tile side, or 0.

#include "stencil_tile.cuh"

namespace {

using namespace nlheat;

constexpr int MAX_CASES = 65535;  // gridDim.z

template <typename T, typename OpT, int EPS, int WARPS>
__global__ void __launch_bounds__(32 * WARPS)
batched_superstep2d_fast(const T* __restrict__ u, T* __restrict__ out, int nx, int ny, int K,
                         int ot, const T* __restrict__ params, T wsum) {
  const int b = blockIdx.z;
  const size_t base = static_cast<size_t>(b) * nx * ny;  // case b's plane
  superstep_levels<T, OpT, EPS, WARPS>(u + base, out + base, nx, ny, K, ot, params[2 * b],
                                       wsum, params[2 * b + 1]);
}

template <typename T, typename OpT, int MW, int K>
__global__ void __launch_bounds__(THREADS)
batched_superstep2d_kernel(const T* __restrict__ u, T* __restrict__ out, int nx, int ny,
                           int eps, int ot, const Plan plan, const T* __restrict__ params,
                           T wsum) {
  const int b = blockIdx.z;
  const size_t base = static_cast<size_t>(b) * nx * ny;  // case b's plane
  superstep_tile_levels<T, OpT, MW, K>(u + base, out + base, nx, ny, eps, ot, plan,
                                       params[2 * b], wsum, params[2 * b + 1]);
}

template <typename T, typename OpT>
int launch(const void* u, void* out, const void* params, int batch, int nx, int ny, int eps,
           int ksteps, double wsum, void* stream) {
  if (eps < 0 || eps > MAX_EPS || ksteps < 1 || ksteps > SUPERSTEP_MAX_K) return -1;
  if (batch < 0 || batch > MAX_CASES) return -1;
  constexpr bool BF16 = !std::is_same<T, OpT>::value;
  const int ot = superstep_ot<T>(eps, ksteps, BF16);
  if (ot == 0) return -1;
  if ((static_cast<long long>(nx) + ot - 1) / ot > 65535) return -1;  // gridDim.y
  if (batch == 0 || nx <= 0 || ny <= 0) return 0;
  const size_t smem = superstep_smem<T>(ot, eps, ksteps, BF16);
  const dim3 grid((ny + ot - 1) / ot, (nx + ot - 1) / ot, batch);
  const auto st = static_cast<cudaStream_t>(stream);
  const auto pu = static_cast<const T*>(u);
  const auto po = static_cast<T*>(out);
  const auto pp = static_cast<const T*>(params);
  if (eps <= SUPERSTEP_FAST_MAX_EPS)
    return with_eps<SUPERSTEP_FAST_MAX_EPS>(eps, [&](auto e) {
      constexpr int EPS = decltype(e)::value;
      return superstep_launch(batched_superstep2d_fast<T, OpT, EPS, 4>,
                              batched_superstep2d_fast<T, OpT, EPS, 6>, grid, smem, st, pu, po,
                              nx, ny, ksteps, ot, pp, static_cast<T>(wsum));
    });
  auto body = [&](auto mw) {  // the tile body
    constexpr int MW = decltype(mw)::value;
    auto go = [&](auto kernel) {
      const int e = allow_smem(kernel, smem);
      if (e != 0) return e;
      kernel<<<grid, dim3(TILE_Y, THREADS_Y), smem, st>>>(pu, po, nx, ny, eps, ot,
                                                          make_plan(eps), pp,
                                                          static_cast<T>(wsum));
      return static_cast<int>(cudaGetLastError());
    };
    switch (ksteps) {
      case 1: return go(batched_superstep2d_kernel<T, OpT, MW, 1>);
      case 2: return go(batched_superstep2d_kernel<T, OpT, MW, 2>);
      case 3: return go(batched_superstep2d_kernel<T, OpT, MW, 3>);
      default: return go(batched_superstep2d_kernel<T, OpT, MW, 4>);
    }
  };
  if (eps <= 16) return body(std::integral_constant<int, wrows_for(16)>{});
  if (eps <= 32) return body(std::integral_constant<int, wrows_for(32)>{});
  return body(std::integral_constant<int, wrows_for(MAX_EPS)>{});
}

template <typename T>
int launch_typed(int bf16, const void* u, void* out, const void* params, int batch, int nx,
                 int ny, int eps, int ksteps, double wsum, void* stream) {
  return (bf16 ? &launch<T, __nv_bfloat16> : &launch<T, T>)(u, out, params, batch, nx, ny, eps,
                                                           ksteps, wsum, stream);
}

}  // namespace

// dtype: 0 = float32, 1 = float64.  bf16: 1 selects the bfloat16 operand
// tier.  u and out are (batch, nx, ny) stacks that must not overlap; params
// is the (batch, 2) table of each case's (scale, dt) in the state type.
extern "C" int nlheat_batched_superstep2d(int dtype, int bf16, const void* u, void* out,
                                          const void* params, int batch, int nx, int ny,
                                          int eps, int ksteps, double wsum, void* stream) {
  if (dtype == 0)
    return launch_typed<float>(bf16, u, out, params, batch, nx, ny, eps, ksteps, wsum, stream);
  if (dtype == 1)
    return launch_typed<double>(bf16, u, out, params, batch, nx, ny, eps, ksteps, wsum, stream);
  return -1;
}

// The output tile side a K-step launch would use at this eps, dtype and
// tier (64 or 32), or 0 when it does not fit the card's shared memory.
extern "C" int nlheat_batched_superstep2d_fits(int dtype, int bf16, int eps, int ksteps) {
  if (eps < 0 || eps > MAX_EPS || ksteps < 1 || ksteps > SUPERSTEP_MAX_K) return 0;
  if (dtype == 0) return superstep_ot<float>(eps, ksteps, bf16 != 0);
  if (dtype == 1) return superstep_ot<double>(eps, ksteps, bf16 != 0);
  return 0;
}
