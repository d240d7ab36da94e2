// K forward-Euler steps per launch by trapezoidal temporal blocking, for
// NVIDIA Hopper (sm_90a).
//
// Replaces the Pallas TPU kernel
//   superstep2d <- nonlocalheatequation_tpu/ops/pallas_kernel.py:_build_superstep_kernel
//                  (make_superstep_multi_step_fn)
//
// Each block owns an OT x OT output tile (OT = 64 or 32) of the unpadded
// (nx, ny) state.  It stages the window widened by K*eps on every side,
// S = OT + 2K*eps, in shared memory, then advances it K levels there: level
// j computes the band of side OT + 2(K-j)*eps centred on the tile from level
// j-1's band (the window for j = 1).  Every level's band is masked to the
// domain (0 outside), which is the volumetric boundary condition re-applied
// every level, so a level's values are exactly what the per-step kernel
// gives after j steps.  Only level K, the output tile, is written to device
// memory.
//
// The order of the adds is the contract shared with stencil_tile.cuh and
// batched_step2d.cu: each window row's W_0 = row[0], W_h = (W_{h-1} +
// row[-h]) + row[+h]; each output adds W_{h_i} of its x offsets i from 0,
// heights ascending, then i ascending; the epilogue rounds every multiply
// and add on its own.  So K levels are bit-identical to K step2d launches
// and to superstep2d_plain (ops/cuda_kernel.py, which sums in disc_sum's
// order).
//
// Design, for 0 <= eps <= SUPERSTEP_FAST_MAX_EPS (8): the register design
// of batched_step2d.cu (stencil_tile.cuh, register_sums, superstep_levels).  A block of four
// warps (six where just two blocks share an SM) stages its window by
// cp.async, the cells outside the domain zero-filled by the copy itself.
// Each level's band is cut into items of 32 columns by RUN rows (RUN = 32
// in float32, 16 in float64; the last item of a row or column shifted back
// to end at the band's edge, its overlap not written twice), dealt over the
// warps.  A thread owns one column of an item: it keeps W_h of the RUN +
// 2eps window rows it needs in registers, reading the level buffer in
// shared memory (two reads a height a row), and adds each height's x
// offsets from those registers.  No barrier falls inside a level; one
// separates the levels.  Where two or more blocks share an SM (OT = 64 in
// float32 up to eps=8 at K=3), one block's load overlaps another's levels.
//
// Redundant work: the levels compute the items' points, sum_j
// ceil(band_j/32) * ceil(band_j/RUN) * 32*RUN, for K*OT^2 of output; at
// eps=8, f32, OT=64 that is 1.63x at K=2 and 1.83x at K=3 (the band of
// level j rounded up to whole items; the tile body's 32 x 32 sub-tiles give
// the same counts).  Shared memory per point and level: (RUN + 2eps)(2eps +
// 1)/RUN reads for the column sums (25.5 at eps=8, f32), one centre read
// and one write, against about 2(2eps+1) + (2eps+1)(32+2eps)/32 + 2 a point
// and 2(eps+1) barriers a sub-tile in the tile body.
//
// eps 9-64 run the shared tile body (stencil_tile.cuh window_sums, 32 x 32
// sub-tiles one after another, two barriers a height), which gives the same
// bits.  The register design stops at eps=8 to keep the build short: each
// eps is eight fully unrolled instantiations (two types, two tiers, two
// warp counts).
//
// bf16 tier: the state buffers stay in full precision.  The register design
// rounds every cell it reads for the sums and the operator's centre to
// bfloat16 (stencil_tile.cuh Operand), while the carry reads the unrounded
// state; the tile body rounds the band it reads into a third buffer first.
// Either way each level rounds only its operator's operand, as the per-step
// bf16 tier does.
//
// What bounds it on an H100 SXM (published peaks, computed, not measured):
// one state read and one written per launch, so K steps move the bytes of
// one (about 40 us at 4096^2, eps=8, f32); the operations are K times the
// step's (about 10 us each) plus the redundant bands.  Inside the SM the
// shared-memory reads above bind first.
//
// Plain C interface (ops/_build.py, ops/cuda_kernel.py): launches on the
// given stream, allocates nothing, returns cudaGetLastError() or -1 when K,
// eps, the shared memory or the grid is beyond the kernel's limits.
// nlheat_superstep2d_fits is the fit gate: the output tile side, or 0.

#include "stencil_tile.cuh"

namespace {

using namespace nlheat;

// The levels of both designs are stencil_tile.cuh's (superstep_levels,
// superstep_tile_levels), which batched_superstep2d.cu runs on each case's
// plane.
template <typename T, typename OpT, int EPS, int WARPS>
__global__ void __launch_bounds__(32 * WARPS)
superstep2d_fast(const T* __restrict__ u, T* __restrict__ out, int nx, int ny, int K, int ot,
                 T scale, T wsum, T dt) {
  superstep_levels<T, OpT, EPS, WARPS>(u, out, nx, ny, K, ot, scale, wsum, dt);
}

template <typename T, typename OpT, int MW, int K>
__global__ void __launch_bounds__(THREADS)
superstep2d_kernel(const T* __restrict__ u, T* __restrict__ out, int nx, int ny, int eps,
                   int ot, const Plan plan, T scale, T wsum, T dt) {
  superstep_tile_levels<T, OpT, MW, K>(u, out, nx, ny, eps, ot, plan, scale, wsum, dt);
}

template <typename T, typename OpT>
int launch(const void* u, void* out, int nx, int ny, int eps, int ksteps, double scale,
           double wsum, double dt, void* stream) {
  if (eps < 0 || eps > MAX_EPS || ksteps < 1 || ksteps > SUPERSTEP_MAX_K) return -1;
  constexpr bool BF16 = !std::is_same<T, OpT>::value;
  const int ot = superstep_ot<T>(eps, ksteps, BF16);
  if (ot == 0) return -1;
  if ((static_cast<long long>(nx) + ot - 1) / ot > 65535) return -1;  // gridDim.y
  if (nx <= 0 || ny <= 0) return 0;
  const size_t smem = superstep_smem<T>(ot, eps, ksteps, BF16);
  const dim3 grid((ny + ot - 1) / ot, (nx + ot - 1) / ot);
  const auto st = static_cast<cudaStream_t>(stream);
  const auto pu = static_cast<const T*>(u);
  const auto po = static_cast<T*>(out);
  if (eps <= SUPERSTEP_FAST_MAX_EPS)
    return with_eps<SUPERSTEP_FAST_MAX_EPS>(eps, [&](auto e) {
      constexpr int EPS = decltype(e)::value;
      return superstep_launch(superstep2d_fast<T, OpT, EPS, 4>, superstep2d_fast<T, OpT, EPS, 6>,
                              grid, smem, st, pu, po, nx, ny, ksteps, ot, static_cast<T>(scale),
                              static_cast<T>(wsum), static_cast<T>(dt));
    });
  auto body = [&](auto mw) {  // the tile body, instantiated only above SUPERSTEP_FAST_MAX_EPS
    constexpr int MW = decltype(mw)::value;
    auto go = [&](auto kernel) {
      const int e = allow_smem(kernel, smem);
      if (e != 0) return e;
      kernel<<<grid, dim3(TILE_Y, THREADS_Y), smem, st>>>(
          pu, po, nx, ny, eps, ot, make_plan(eps), static_cast<T>(scale),
          static_cast<T>(wsum), static_cast<T>(dt));
      return static_cast<int>(cudaGetLastError());
    };
    switch (ksteps) {
      case 1: return go(superstep2d_kernel<T, OpT, MW, 1>);
      case 2: return go(superstep2d_kernel<T, OpT, MW, 2>);
      case 3: return go(superstep2d_kernel<T, OpT, MW, 3>);
      default: return go(superstep2d_kernel<T, OpT, MW, 4>);
    }
  };
  if (eps <= 16) return body(std::integral_constant<int, wrows_for(16)>{});
  if (eps <= 32) return body(std::integral_constant<int, wrows_for(32)>{});
  return body(std::integral_constant<int, wrows_for(MAX_EPS)>{});
}

}  // namespace

// dtype: 0 = float32, 1 = float64.  bf16: 1 selects the bfloat16 operand
// tier.  u and out are (nx, ny) states that must not overlap.
extern "C" int nlheat_superstep2d(int dtype, int bf16, const void* u, void* out, int nx,
                                  int ny, int eps, int ksteps, double scale, double wsum,
                                  double dt, void* stream) {
  if (dtype == 0)
    return (bf16 ? &launch<float, __nv_bfloat16> : &launch<float, float>)(
        u, out, nx, ny, eps, ksteps, scale, wsum, dt, stream);
  if (dtype == 1)
    return (bf16 ? &launch<double, __nv_bfloat16> : &launch<double, double>)(
        u, out, nx, ny, eps, ksteps, scale, wsum, dt, stream);
  return -1;
}

// The output tile side a K-step launch would use at this eps, dtype and
// tier (64 or 32), or 0 when it does not fit the card's shared memory.
extern "C" int nlheat_superstep2d_fits(int dtype, int bf16, int eps, int ksteps) {
  if (eps < 0 || eps > MAX_EPS || ksteps < 1 || ksteps > SUPERSTEP_MAX_K) return 0;
  if (dtype == 0) return superstep_ot<float>(eps, ksteps, bf16 != 0);
  if (dtype == 1) return superstep_ot<double>(eps, ksteps, bf16 != 0);
  return 0;
}
