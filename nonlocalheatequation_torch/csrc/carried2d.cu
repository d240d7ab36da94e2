// One forward-Euler step of the 2D state kept in a halo-padded frame, for
// NVIDIA Hopper (sm_90a).
//
// Replaces the Pallas TPU kernel
//   carried2d <- nonlocalheatequation_tpu/ops/pallas_kernel.py:_build_carried_kernel
//                (make_carried_multi_step_fn): the state lives in a padded
//                frame across steps and the kernel re-zeroes the halo.
//
// The frame is (R, L) = (nx + 2eps, ny + 2eps) with the state in its
// interior.  The grid covers the whole frame in 32 x 32 tiles: an interior
// cell gets the step, a halo cell gets 0, so the output frame is written
// whole and may come from torch.empty.  The tile body (window load, sums,
// epilogue) is stencil_tile.cuh's, so a run of carried2d launches is
// bit-identical to the same number of step2d launches.
//
// bf16 tier: the frame is a pair, the state-type master and its bf16
// shadow (the rounding of the master, as __nv_bfloat16).  The window streams
// from the shadow (half the bytes of the overlapping read), the carry reads
// the master's centre, and both next frames are written; the next shadow is
// the rounding of the next master, so the operand every step sees equals
// the per-step kernel's rounding of the state.
//
// What bounds it on an H100 SXM (published peaks, computed, not measured):
// the same as step2d, one frame read and one written per step (about 40 us
// at 4096^2, eps=8, f32), against about 10 us of operations; the halo adds
// (R*L - nx*ny)/(nx*ny), 0.8% at that size.
//
// Plain C interface (ops/_build.py, ops/cuda_kernel.py): launches on the
// given stream, allocates nothing, returns cudaGetLastError() or -1 when
// eps, the shared-memory tile or the grid is beyond the kernel's limits.

#include "stencil_tile.cuh"

namespace {

using namespace nlheat;

template <typename T, typename OpT, int MW>
__global__ void __launch_bounds__(THREADS)
carried2d_kernel(const T* __restrict__ frame, const __nv_bfloat16* __restrict__ shadow,
                 T* __restrict__ out, __nv_bfloat16* __restrict__ out_shadow, int nx, int ny,
                 int eps, const Plan plan, T scale, T wsum, T dt) {
  constexpr bool BF16 = !std::is_same<T, OpT>::value;
  extern __shared__ __align__(16) unsigned char smem_raw[];
  const int R = nx + 2 * eps, L = ny + 2 * eps;
  const int wc = TILE_Y + 2 * eps;
  T* tile = reinterpret_cast<T*>(smem_raw);
  T* wbuf = tile + (TILE_X + 2 * eps) * wc;
  const int tx = threadIdx.x, ty = threadIdx.y;
  const int x0 = blockIdx.y * TILE_X, y0 = blockIdx.x * TILE_Y;  // frame coordinates

  if constexpr (BF16)
    load_window<T, OpT>(tile, wc, TILE_X + 2 * eps, wc, shadow, R, L, x0 - eps, y0 - eps);
  else
    load_window<T, OpT>(tile, wc, TILE_X + 2 * eps, wc, frame, R, L, x0 - eps, y0 - eps);
  __syncthreads();
  T acc[ROWS_PER_THREAD];
  window_sums<T, MW>(tile, wc, eps, plan, wbuf, acc);

#pragma unroll
  for (int k = 0; k < ROWS_PER_THREAD; ++k) {
    const int xl = ty + k * THREADS_Y;
    const int r = x0 + xl, c = y0 + tx;
    if (r >= R || c >= L) continue;
    const size_t o = static_cast<size_t>(r) * L + c;
    T val = T(0);
    if (r >= eps && r < eps + nx && c >= eps && c < eps + ny) {
      const T center = tile[(xl + eps) * wc + tx + eps];
      const T du = operator_du(acc[k], center, scale, wsum);
      val = euler(BF16 ? frame[o] : center, dt, du);
    }
    out[o] = val;
    if constexpr (BF16) out_shadow[o] = __float2bfloat16_rn(static_cast<float>(val));
  }
}

template <typename T, typename OpT>
int launch(const void* frame, const void* shadow, void* out, void* out_shadow, int nx, int ny,
           int eps, double scale, double wsum, double dt, void* stream) {
  if (eps < 0 || eps > MAX_EPS) return -1;
  const size_t smem = tile_smem_bytes<T>(eps);
  if (smem > static_cast<size_t>(smem_limit())) return -1;
  const long long R = static_cast<long long>(nx) + 2 * eps;
  if ((R + TILE_X - 1) / TILE_X > 65535) return -1;  // gridDim.y
  if (nx <= 0 || ny <= 0) return 0;
  return with_mw(eps, [&](auto mw) {
    auto kernel = carried2d_kernel<T, OpT, decltype(mw)::value>;
    const int e = allow_smem(kernel, smem);
    if (e != 0) return e;
    const dim3 block(TILE_Y, THREADS_Y);
    const dim3 grid((ny + 2 * eps + TILE_Y - 1) / TILE_Y, static_cast<int>((R + TILE_X - 1) / TILE_X));
    kernel<<<grid, block, smem, static_cast<cudaStream_t>(stream)>>>(
        static_cast<const T*>(frame), static_cast<const __nv_bfloat16*>(shadow),
        static_cast<T*>(out), static_cast<__nv_bfloat16*>(out_shadow), nx, ny, eps,
        make_plan(eps), static_cast<T>(scale), static_cast<T>(wsum), static_cast<T>(dt));
    return static_cast<int>(cudaGetLastError());
  });
}

template <typename T>
int carried_typed(const void* frame, const void* shadow, void* out, void* out_shadow, int nx,
                  int ny, int eps, double scale, double wsum, double dt, void* stream) {
  auto fn = shadow != nullptr ? &launch<T, __nv_bfloat16> : &launch<T, T>;
  return fn(frame, shadow, out, out_shadow, nx, ny, eps, scale, wsum, dt, stream);
}

}  // namespace

// dtype: 0 = float32, 1 = float64.  frame and out are (nx+2eps, ny+2eps)
// frames of the state type.  shadow == nullptr selects the full-precision
// tier; otherwise shadow and out_shadow are the bf16 frames of the pair.
extern "C" int nlheat_carried2d(int dtype, const void* frame, const void* shadow, void* out,
                                void* out_shadow, int nx, int ny, int eps, double scale,
                                double wsum, double dt, void* stream) {
  if (dtype == 0)
    return carried_typed<float>(frame, shadow, out, out_shadow, nx, ny, eps, scale, wsum, dt,
                                stream);
  if (dtype == 1)
    return carried_typed<double>(frame, shadow, out, out_shadow, nx, ny, eps, scale, wsum, dt,
                                 stream);
  return -1;
}
