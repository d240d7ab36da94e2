// Masked-circle neighbour sum for the 2D nonlocal heat operator, for NVIDIA
// Hopper (sm_90a).
//
// Replaces the Pallas TPU kernel
//   nsum2d  <- nonlocalheatequation_tpu/ops/pallas_kernel.py:build_neighbor_sum_2d
//              (the method="pallas" branch of NonlocalOp2D.neighbor_sum_padded)
// The fused Euler step (step2d, pallas_kernel.py:_build_step_kernel) is one
// batched_step2d.cu launch at B=1 (ops/cuda_kernel.py).  It runs every step
// of the collective distributed 2D solve (one launch a block a step,
// parallel/distributed2d.py through NonlocalOp2D.apply_padded), the test
// form's L(G) once a solve, and the vmap ensemble buckets.
//
// What bounds it on an H100 SXM (NVIDIA's published peaks at the card's
// 700 W limit: 3.35 TB/s HBM3, 67 TFLOP/s f32 outside the tensor cores;
// computed bounds, not measurements): at 4096^2, eps=8, f32 it reads the
// padded block once and writes the sum once, about 40 us.  The direct sum
// is 197 terms (196 adds) per point, 3.3 G adds, about 49 us at the f32
// peak; the row window sums below cut that to 41 adds per point (about
// 10 us), so it is bound by bytes.
//
// Design, for 0 <= eps <= REG_TILES_MAX_EPS (16): the register walk of
// batched_carried2d.cu (stencil_tile.cuh, reg_walk) over the (nx, ny)
// output, the padded block as the source at offset eps: a persistent grid
// over RUN*4 x 32 tiles (RUN = 32 in float32, 16 in float64), each window
// staged by cp.async from the padded block, double-buffered, the column
// sums in registers (register_sums), the sum itself the epilogue.  The
// stage copies 16 bytes a copy where the block's base and row pitch (ny +
// 2eps) and the window's row width (32 + 2eps) are 16-byte aligned
// (stage_frame: every 4096^2 and 2048^2 frame at eps=8), else a value a
// copy.  eps 17-64, and a float32 lattice of fewer tiles than the card has
// SMs (reg_tiles_too_few: a 512^2 plane), keep the tile body: one block a
// 32 x 32 output tile stages its (32+2eps)^2 window in shared memory
// (load_window), and the per-row window sums (window_sums, about 2eps+1 +
// (2eps+1)(32+2eps)/32 shared-memory reads per point instead of 197) add
// in the same order, so both designs give the same bits.  Types: state
// float or double, operand the state type or __nv_bfloat16 (the walk
// rounds the staged window in place).
//
// Plain C interface (loaded with ctypes by ops/_build.py and wrapped in
// ops/cuda_kernel.py).  The entry point launches on the given stream,
// allocates nothing and returns cudaGetLastError() (0 = launched), or -1
// when eps, the shared-memory tile or the grid is beyond what the kernel
// supports.  These limits live here only; the wrapper turns -1 into a
// ValueError.

#include "stencil_tile.cuh"

namespace {

using namespace nlheat;

// -- the shared tile body (stencil_tile.cuh): eps above REG_TILES_MAX_EPS and
// small float32 lattices ----------------------------------------------------------

// Copy the entries of plan that window_sums reads (2eps+1 offsets, eps+2
// group starts) into splan, the block's static shared copy; the caller
// synchronises before window_sums.  window_sums reads the plan at a
// loop-carried index: from the kernel parameter nvcc compiled that to
// per-thread constant loads here, which slowed the sums at 4096^2; from
// shared memory it is a broadcast read.  The copy costs each block a
// little, which the batched tile bodies' small lattices did not repay
// (PERF.md section 6), so they read the parameter.
__device__ inline void stage_plan(Plan& splan, const Plan& plan, int eps) {
  if (threadIdx.y == 0) {
    for (int i = threadIdx.x; i <= 2 * eps; i += TILE_Y) splan.ord[i] = plan.ord[i];
    for (int i = threadIdx.x; i <= eps + 1; i += TILE_Y) splan.hstart[i] = plan.hstart[i];
  }
}

// upad is the (nx + 2eps, ny + 2eps) halo-padded block, row-major; window
// cell (a, b) of the tile at output origin (x0, y0) is upad[x0 + a][y0 + b].
template <typename T, typename OpT, int MW>
__global__ void __launch_bounds__(THREADS)
nsum2d_kernel(const T* __restrict__ upad, T* __restrict__ out, int nx, int ny, int eps,
              const Plan plan) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  const int wc = TILE_Y + 2 * eps;
  T* tile = reinterpret_cast<T*>(smem_raw);
  T* wbuf = tile + (TILE_X + 2 * eps) * wc;
  const int tx = threadIdx.x, ty = threadIdx.y;
  const int x0 = blockIdx.y * TILE_X, y0 = blockIdx.x * TILE_Y;

  __shared__ Plan splan;
  stage_plan(splan, plan, eps);
  load_window<T, OpT>(tile, wc, TILE_X + 2 * eps, wc, upad, nx + 2 * eps, ny + 2 * eps, x0,
                      y0);
  __syncthreads();
  T acc[ROWS_PER_THREAD];
  window_sums<T, MW>(tile, wc, eps, splan, wbuf, acc);

#pragma unroll
  for (int k = 0; k < ROWS_PER_THREAD; ++k) {
    const int x = x0 + ty + k * THREADS_Y, y = y0 + tx;
    if (x < nx && y < ny) out[static_cast<size_t>(x) * ny + y] = acc[k];
  }
}

// -- the register walk (stencil_tile.cuh, reg_walk), eps 0-16 ---------------------

template <typename T, typename OpT, int EPS>
__global__ void __launch_bounds__(REG_THREADS)
nsum2d_fast(const T* __restrict__ upad, T* __restrict__ out, int nx, int ny, int nty,
            long long ntiles, bool vec) {
  constexpr int RUN = RegTile<T>::RUN, ROWS = RegTile<T>::ROWS, COLS = RegTile<T>::COLS;
  const int L = ny + 2 * EPS;
  const Span2 frame{0, nx + 2 * EPS, 0, L};
  const int r0 = threadIdx.y * RUN;
  reg_walk<T, OpT, EPS>(
      ntiles,
      [&](T* buf, long long t) {
        // the window of output (x0, y0) starts at padded cell (x0, y0)
        stage_frame<T, EPS>(buf, upad, L, frame, static_cast<int>(t / nty) * ROWS,
                            static_cast<int>(t % nty) * COLS, vec);
      },
      [&](long long t, const T* /*col*/, const T (&acc)[RUN]) {
        const int x0 = static_cast<int>(t / nty) * ROWS + r0;
        const int y = static_cast<int>(t % nty) * COLS + threadIdx.x;
        if (y >= ny) return;
#pragma unroll
        for (int r = 0; r < RUN; ++r)
          if (x0 + r < nx) out[static_cast<size_t>(x0 + r) * ny + y] = acc[r];
      });
}

template <typename T, typename OpT, int EPS>
int launch_fast(const void* upad, void* out, int nx, int ny, cudaStream_t stream) {
  static int per_sm = -1;  // blocks an SM holds, asked once per instantiation
  const int nty = (ny + RegTile<T>::COLS - 1) / RegTile<T>::COLS;
  const long long ntiles =
      static_cast<long long>((nx + RegTile<T>::ROWS - 1) / RegTile<T>::ROWS) * nty;
  const int L = ny + 2 * EPS;
  const bool vec = stage_frame_vec<T, EPS>(upad, L, Span2{0, nx + 2 * EPS, 0, L}, true);
  return reg_tiles_launch<T, EPS>(nsum2d_fast<T, OpT, EPS>, ntiles, per_sm, stream,
                                  static_cast<const T*>(upad), static_cast<T*>(out), nx, ny,
                                  nty, ntiles, vec);
}

// The register walk where eps and the lattice allow it, else the tile body.
template <typename T, typename OpT>
int launch(const void* upad, void* out, int nx, int ny, int eps, void* stream) {
  if (eps < 0 || eps > MAX_EPS) return -1;
  const size_t smem = tile_smem_bytes<T>(eps);  // dynamic, beside the static plan
  if (smem + sizeof(Plan) > static_cast<size_t>(smem_limit())) return -1;
  if ((static_cast<long long>(nx) + TILE_X - 1) / TILE_X > 65535) return -1;  // gridDim.y
  if (nx <= 0 || ny <= 0) return 0;
  if (eps <= REG_TILES_MAX_EPS && !reg_tiles_too_few<T>(1, nx, ny))
    return with_eps<REG_TILES_MAX_EPS>(eps, [&](auto e) {
      return launch_fast<T, OpT, decltype(e)::value>(upad, out, nx, ny,
                                                      static_cast<cudaStream_t>(stream));
    });
  return with_mw(eps, [&](auto mw) {
    auto kernel = nsum2d_kernel<T, OpT, decltype(mw)::value>;
    const int e = allow_smem(kernel, smem, sizeof(Plan));
    if (e != 0) return e;
    const dim3 block(TILE_Y, THREADS_Y);
    const dim3 grid((ny + TILE_Y - 1) / TILE_Y, (nx + TILE_X - 1) / TILE_X);
    kernel<<<grid, block, smem, static_cast<cudaStream_t>(stream)>>>(
        static_cast<const T*>(upad), static_cast<T*>(out), nx, ny, eps, make_plan(eps));
    return static_cast<int>(cudaGetLastError());
  });
}

template <typename T>
int nsum_typed(int bf16, const void* upad, void* out, int nx, int ny, int eps, void* stream) {
  auto fn = bf16 ? &launch<T, __nv_bfloat16> : &launch<T, T>;
  return fn(upad, out, nx, ny, eps, stream);
}

}  // namespace

// dtype: 0 = float32, 1 = float64.  bf16: 1 selects the bfloat16 operand
// tier.  upad is the (nx+2eps, ny+2eps) block, out the (nx, ny) sum.
extern "C" int nlheat_nsum2d(int dtype, int bf16, const void* upad, void* out, int nx,
                             int ny, int eps, void* stream) {
  if (dtype == 0) return nsum_typed<float>(bf16, upad, out, nx, ny, eps, stream);
  if (dtype == 1) return nsum_typed<double>(bf16, upad, out, nx, ny, eps, stream);
  return -1;
}
