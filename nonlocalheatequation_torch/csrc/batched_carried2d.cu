// One forward-Euler step of B independent 2D solves, each kept in a
// halo-padded frame, in one launch, for NVIDIA Hopper (sm_90a).
//
// Replaces the Pallas TPU kernel
//   batched_carried2d <- nonlocalheatequation_tpu/ops/pallas_kernel.py:
//                        _build_batched_carried_kernel
//                        (make_batched_carried_multi_step_fn)
//
// The stack is (B, R, L) frames, (R, L) = (nx + 2eps, ny + 2eps), each
// case's state in its frame's interior.  The grid is carried2d's 32 x 32
// tile lattice over one frame with the case index as blockIdx.z; an
// interior cell gets the step, a halo cell 0, so the output stack is
// written whole.  Each block runs carried2d's tile body (stencil_tile.cuh)
// on its case's frame, so lane b is bit-identical to one carried2d launch
// on case b, hence to one step2d launch.
//
// bf16 tier: the stack is a pair, the state-type masters and their bf16
// shadows; the window streams from the shadow, the carry reads the master,
// and both next stacks are written, as in carried2d.
//
// Per-case physics: each case reads its (scale, dt) from a (B, 2) table in
// the state type (see batched_step2d.cu: the epilogue rounds each operation
// on its own, so a table read gives the bits of a by-value scalar), and one
// launch serves uniform and mixed chunks alike.  Production form only.
//
// What bounds it on an H100 SXM (published peaks, computed, not measured):
// one frame stack read and one written per step, about 20 us at
// 8 x 1024^2, eps=8, f32 (the halo adds 3.2% at that size), against about
// 5 us of operations.
//
// Plain C interface (ops/_build.py, ops/cuda_batched.py): launches on the
// given stream, allocates nothing, returns cudaGetLastError() or -1 when
// eps, the shared-memory tile, the grid or the case count is beyond the
// kernel's limits.

#include "stencil_tile.cuh"

namespace {

using namespace nlheat;

constexpr int MAX_CASES = 65535;  // gridDim.z

template <typename T, typename OpT, int MW>
__global__ void __launch_bounds__(THREADS)
batched_carried2d_kernel(const T* __restrict__ frame, const __nv_bfloat16* __restrict__ shadow,
                         T* __restrict__ out, __nv_bfloat16* __restrict__ out_shadow, int nx,
                         int ny, int eps, const Plan plan, const T* __restrict__ params,
                         T wsum) {
  constexpr bool BF16 = !std::is_same<T, OpT>::value;
  extern __shared__ __align__(16) unsigned char smem_raw[];
  const int R = nx + 2 * eps, L = ny + 2 * eps;
  const int wc = TILE_Y + 2 * eps;
  T* tile = reinterpret_cast<T*>(smem_raw);
  T* wbuf = tile + (TILE_X + 2 * eps) * wc;
  const int tx = threadIdx.x, ty = threadIdx.y;
  const int x0 = blockIdx.y * TILE_X, y0 = blockIdx.x * TILE_Y;  // frame coordinates
  const int b = blockIdx.z;
  const size_t base = static_cast<size_t>(b) * R * L;  // case b's frame
  const T scale = params[2 * b], dt = params[2 * b + 1];

  if constexpr (BF16)
    load_window<T, OpT>(tile, wc, TILE_X + 2 * eps, wc, shadow + base, R, L, x0 - eps,
                        y0 - eps);
  else
    load_window<T, OpT>(tile, wc, TILE_X + 2 * eps, wc, frame + base, R, L, x0 - eps,
                        y0 - eps);
  __syncthreads();
  T acc[ROWS_PER_THREAD];
  window_sums<T, MW>(tile, wc, eps, plan, wbuf, acc);

#pragma unroll
  for (int k = 0; k < ROWS_PER_THREAD; ++k) {
    const int xl = ty + k * THREADS_Y;
    const int r = x0 + xl, c = y0 + tx;
    if (r >= R || c >= L) continue;
    const size_t o = base + static_cast<size_t>(r) * L + c;
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
int launch(const void* frame, const void* shadow, void* out, void* out_shadow,
           const void* params, int batch, int nx, int ny, int eps, double wsum,
           void* stream) {
  if (eps < 0 || eps > MAX_EPS || batch < 0 || batch > MAX_CASES) return -1;
  const size_t smem = tile_smem_bytes<T>(eps);
  if (smem > static_cast<size_t>(smem_limit())) return -1;
  const long long R = static_cast<long long>(nx) + 2 * eps;
  if ((R + TILE_X - 1) / TILE_X > 65535) return -1;  // gridDim.y
  if (batch == 0 || nx <= 0 || ny <= 0) return 0;
  return with_mw(eps, [&](auto mw) {
    auto kernel = batched_carried2d_kernel<T, OpT, decltype(mw)::value>;
    const int e = allow_smem(kernel, smem);
    if (e != 0) return e;
    const dim3 block(TILE_Y, THREADS_Y);
    const dim3 grid((ny + 2 * eps + TILE_Y - 1) / TILE_Y,
                    static_cast<int>((R + TILE_X - 1) / TILE_X), batch);
    kernel<<<grid, block, smem, static_cast<cudaStream_t>(stream)>>>(
        static_cast<const T*>(frame), static_cast<const __nv_bfloat16*>(shadow),
        static_cast<T*>(out), static_cast<__nv_bfloat16*>(out_shadow), nx, ny, eps,
        make_plan(eps), static_cast<const T*>(params), static_cast<T>(wsum));
    return static_cast<int>(cudaGetLastError());
  });
}

template <typename T>
int carried_typed(const void* frame, const void* shadow, void* out, void* out_shadow,
                  const void* params, int batch, int nx, int ny, int eps, double wsum,
                  void* stream) {
  auto fn = shadow != nullptr ? &launch<T, __nv_bfloat16> : &launch<T, T>;
  return fn(frame, shadow, out, out_shadow, params, batch, nx, ny, eps, wsum, stream);
}

}  // namespace

// dtype: 0 = float32, 1 = float64.  frame and out are (batch, nx+2eps,
// ny+2eps) frame stacks of the state type; params is the (batch, 2) table
// of each case's (scale, dt).  shadow == nullptr selects the full-precision
// tier; otherwise shadow and out_shadow are the bf16 stacks of the pair.
extern "C" int nlheat_batched_carried2d(int dtype, const void* frame, const void* shadow,
                                        void* out, void* out_shadow, const void* params,
                                        int batch, int nx, int ny, int eps, double wsum,
                                        void* stream) {
  if (dtype == 0)
    return carried_typed<float>(frame, shadow, out, out_shadow, params, batch, nx, ny, eps,
                                wsum, stream);
  if (dtype == 1)
    return carried_typed<double>(frame, shadow, out, out_shadow, params, batch, nx, ny, eps,
                                 wsum, stream);
  return -1;
}
