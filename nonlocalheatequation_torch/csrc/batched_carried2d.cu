// One forward-Euler step of B independent 2D solves, each kept in a
// halo-padded frame, in one launch, for NVIDIA Hopper (sm_90a).
//
// Replaces two Pallas TPU kernels of nonlocalheatequation_tpu/ops/pallas_kernel.py:
//   batched_carried2d <- _build_batched_carried_kernel
//                        (make_batched_carried_multi_step_fn)
//   carried2d         <- _build_carried_kernel (make_carried_multi_step_fn):
//                        one launch at B = 1 (ops/cuda_kernel.carried2d,
//                        counted as carried2d)
//
// The stack is (B, R, L) frames, (R, L) = (nx + 2eps, ny + 2eps), each
// case's state in its frame's interior.  Lane b is bit-identical to a
// B = 1 launch on case b, hence to one step2d launch, and to lane b of one
// batched_step2d launch: the sums and the epilogue are the 2D tile bodies'
// (stencil_tile.cuh).
//
// Design, for 0 <= eps <= REG_TILES_MAX_EPS (16): batched_step2d's register
// walk (stencil_tile.cuh, reg_tiles) over each case's interior, the frame
// stack as the source at offset eps: a persistent grid over (case, row
// tile, column tile), RUN*4 x 32 tiles, each window staged by cp.async from
// the frame (its halo supplies the zeros of the boundary condition),
// double-buffered, the column sums in registers (register_sums).  eps
// 17-64, and a float32 lattice of fewer tiles than the card has SMs
// (reg_tiles_too_few, as batched_step2d): the shared tile body, one 32 x 32
// tile of the interior a block with the case index as blockIdx.z.  Either
// writes the interiors only: the
// output stacks' halos must already be zero (the wrapper zeroes them;
// the multi-step maker's two stacks keep the zero halos they were made
// with).
//
// bf16 tier: the operand is the state's bf16 rounding (through float32, to
// nearest even, as ops/cuda_kernel.shadow_of makes it).  Both designs stage
// the master and round the window in place, as batched_step2d does, so no
// shadow stack is kept: the window holds exactly the values of the master's
// shadow.  The carry reads the master.
//
// Per-case physics: each case reads its (scale, dt) from a (B, 2) table in
// the state type (see batched_step2d.cu: the epilogue rounds each operation
// on its own, so a table read gives the bits of a by-value scalar), and one
// launch serves uniform and mixed chunks alike.  Production form only.
//
// What bounds it on an H100 SXM (published peaks, computed, not measured):
// one frame stack read and one interior stack written per step, about 20 us
// at 8 x 1024^2, eps=8, f32 (the halo adds 3.2% to the bytes read; one
// 4096^2 frame: about 40 us, 0.8% more), against
// about 5 us of operations.  Inside the SM the column sums' shared-memory
// reads come next, as in batched_step2d: about 26 a point at eps=8, f32.
//
// Plain C interface (ops/_build.py, ops/cuda_batched.py): launches on the
// given stream, allocates nothing, returns cudaGetLastError() or -1 when
// eps, the shared-memory tile, the grid or the case count is beyond the
// kernel's limits.

#include "stencil_tile.cuh"

namespace {

using namespace nlheat;

constexpr int MAX_CASES = 65535;  // gridDim.z of the tile body

// -- the register walk (stencil_tile.cuh, reg_tiles), eps 0-16 ----------------------

template <typename T, typename OpT, int EPS>
__global__ void __launch_bounds__(REG_THREADS)
batched_carried2d_fast(const T* __restrict__ frame, T* __restrict__ out, int nx, int ny,
                       int ntx, int nty, long long ntiles, const T* __restrict__ params,
                       T wsum) {
  constexpr bool BF16 = !std::is_same<T, OpT>::value;
  constexpr int RUN = RegTile<T>::RUN, WC = RegTile<T>::COLS + 2 * EPS;
  const int R = nx + 2 * EPS, L = ny + 2 * EPS;
  const int r0 = threadIdx.y * RUN;
  reg_tiles<T, OpT, EPS>(frame, R, L, EPS, ntx, nty, ntiles,
                         [&](TileIndex ti, const T* col, const T (&acc)[RUN]) {
    const size_t base = static_cast<size_t>(ti.b) * R * L;  // case b's frame
    const T scale = params[2 * ti.b], dt = params[2 * ti.b + 1];
    const int y = ti.y0 + threadIdx.x;
#pragma unroll
    for (int r = 0; r < RUN; ++r) {
      const int x = ti.x0 + r0 + r;
      if (x < nx && y < ny) {
        const size_t o = base + static_cast<size_t>(x + EPS) * L + y + EPS;
        const T center = col[(r + EPS) * WC];
        const T val = euler(BF16 ? frame[o] : center, dt,
                            operator_du(acc[r], center, scale, wsum));
        out[o] = val;
      }
    }
  });
}

template <typename T, typename OpT, int EPS>
int launch_fast(const void* frame, void* out, const void* params, int batch, int nx, int ny,
                double wsum, cudaStream_t stream) {
  static int per_sm = -1;  // blocks an SM holds, asked once per instantiation
  const int ntx = (nx + RegTile<T>::ROWS - 1) / RegTile<T>::ROWS;
  const int nty = (ny + RegTile<T>::COLS - 1) / RegTile<T>::COLS;
  const long long ntiles = static_cast<long long>(batch) * ntx * nty;
  return reg_tiles_launch<T, EPS>(
      batched_carried2d_fast<T, OpT, EPS>, ntiles, per_sm, stream, static_cast<const T*>(frame),
      static_cast<T*>(out), nx, ny, ntx, nty, ntiles, static_cast<const T*>(params),
      static_cast<T>(wsum));
}

// -- the shared tile body (stencil_tile.cuh), eps above REG_TILES_MAX_EPS ------------

template <typename T, typename OpT, int MW>
__global__ void __launch_bounds__(THREADS)
batched_carried2d_kernel(const T* __restrict__ frame, T* __restrict__ out, int nx, int ny,
                         int eps, const Plan plan, const T* __restrict__ params, T wsum) {
  constexpr bool BF16 = !std::is_same<T, OpT>::value;
  extern __shared__ __align__(16) unsigned char smem_raw[];
  const int R = nx + 2 * eps, L = ny + 2 * eps;
  const int wc = TILE_Y + 2 * eps;
  T* tile = reinterpret_cast<T*>(smem_raw);
  T* wbuf = tile + (TILE_X + 2 * eps) * wc;
  const int tx = threadIdx.x, ty = threadIdx.y;
  const int x0 = blockIdx.y * TILE_X, y0 = blockIdx.x * TILE_Y;  // interior coordinates
  const int b = blockIdx.z;
  const size_t base = static_cast<size_t>(b) * R * L;  // case b's frame
  const T scale = params[2 * b], dt = params[2 * b + 1];

  // the window of interior (x0 - eps, y0 - eps) starts at frame (x0, y0)
  load_window<T, OpT>(tile, wc, TILE_X + 2 * eps, wc, frame + base, R, L, x0, y0);
  __syncthreads();
  T acc[ROWS_PER_THREAD];
  window_sums<T, MW>(tile, wc, eps, plan, wbuf, acc);

#pragma unroll
  for (int k = 0; k < ROWS_PER_THREAD; ++k) {
    const int xl = ty + k * THREADS_Y;
    const int x = x0 + xl, y = y0 + tx;
    if (x >= nx || y >= ny) continue;
    const size_t o = base + static_cast<size_t>(x + eps) * L + y + eps;
    const T center = tile[(xl + eps) * wc + tx + eps];
    const T val = euler(BF16 ? frame[o] : center, dt, operator_du(acc[k], center, scale, wsum));
    out[o] = val;
  }
}

template <typename T, typename OpT>
int launch(const void* frame, void* out, const void* params, int batch, int nx, int ny, int eps,
           double wsum, void* stream) {
  if (eps < 0 || eps > MAX_EPS || batch < 0 || batch > MAX_CASES) return -1;
  const size_t smem = tile_smem_bytes<T>(eps);
  if (smem > static_cast<size_t>(smem_limit())) return -1;
  if ((static_cast<long long>(nx) + TILE_X - 1) / TILE_X > 65535) return -1;  // gridDim.y
  if (batch == 0 || nx <= 0 || ny <= 0) return 0;
  const auto st = static_cast<cudaStream_t>(stream);
  if (eps <= REG_TILES_MAX_EPS && !reg_tiles_too_few<T>(batch, nx, ny))
    return with_eps<REG_TILES_MAX_EPS>(eps, [&](auto e) {
      return launch_fast<T, OpT, decltype(e)::value>(frame, out, params, batch, nx, ny, wsum,
                                                     st);
    });
  return with_mw(eps, [&](auto mw) {
    auto kernel = batched_carried2d_kernel<T, OpT, decltype(mw)::value>;
    const int e = allow_smem(kernel, smem);
    if (e != 0) return e;
    const dim3 block(TILE_Y, THREADS_Y);
    const dim3 grid((ny + TILE_Y - 1) / TILE_Y, (nx + TILE_X - 1) / TILE_X, batch);
    kernel<<<grid, block, smem, st>>>(
        static_cast<const T*>(frame), static_cast<T*>(out), nx, ny, eps, make_plan(eps),
        static_cast<const T*>(params), static_cast<T>(wsum));
    return static_cast<int>(cudaGetLastError());
  });
}

template <typename T>
int carried_typed(int bf16, const void* frame, void* out, const void* params, int batch, int nx,
                  int ny, int eps, double wsum, void* stream) {
  auto fn = bf16 ? &launch<T, __nv_bfloat16> : &launch<T, T>;
  return fn(frame, out, params, batch, nx, ny, eps, wsum, stream);
}

}  // namespace

// dtype: 0 = float32, 1 = float64; bf16 != 0 selects the bf16 tier.  frame
// and out are (batch, nx+2eps, ny+2eps) frame stacks of the state type;
// out's halos must be zero (the kernel writes the interiors only).  params
// is the (batch, 2) table of each case's (scale, dt).
extern "C" int nlheat_batched_carried2d(int dtype, int bf16, const void* frame, void* out,
                                        const void* params, int batch, int nx, int ny, int eps,
                                        double wsum, void* stream) {
  if (dtype == 0)
    return carried_typed<float>(bf16, frame, out, params, batch, nx, ny, eps, wsum, stream);
  if (dtype == 1)
    return carried_typed<double>(bf16, frame, out, params, batch, nx, ny, eps, wsum, stream);
  return -1;
}
