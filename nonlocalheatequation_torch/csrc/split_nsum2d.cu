// The split neighbour sum of one block of a distributed 2D solve, from its
// filled halo frame, for NVIDIA Hopper (sm_90a).
//
// Replaces the Pallas TPU kernel of nonlocalheatequation_tpu
//   split_nsum2d  <- ops/pallas_halo.py:build_split_nsum_2d (body
//                    _nsum_phases_2d :323): the compute body of the fused
//                    halo kernel, the exchange factored out
// The frame is (bx+2eps, by+2eps), row-major, its halo already filled by
// the band exchange (parallel/halo.py); the output is the (bx, by) sum over
// the masked circle.  One launch computes one phase:
//   INTERIOR  block rows [eps, bx-eps) x columns [eps, by-eps): the cells
//             whose window reads no halo, which the TPU kernel computes while
//             the bands are in flight;
//   RING      the four eps-wide bands around it (top and bottom full width,
//             left and right on the middle rows), as _nsum_phases_2d splits
//             them;
//   ALL       the whole block in one pass (a block with a side <= 2eps has no
//             interior: _degenerate, pallas_halo.py:409).
// (The TPU frame's `pad` rows of roll slack below it are not needed here.)
//
// What bounds it on an H100 SXM (NVIDIA's published peaks at the card's
// 700 W limit: 3.35 TB/s HBM3, 67 TFLOP/s f32 outside the tensor cores;
// computed bounds, not measurements): the function reads the frame once and
// writes the block once, 2 x 16 MiB for a 2048^2 f32 block at eps=8, about
// 10 us; the tile body's 41 adds per point (about 2.6 us at the f32 peak) keep
// it bound by bytes.
//
// Design.  Each phase is a list of up to four rectangles of the output; one
// launch covers every 32 x 32 tile of each rectangle (a 1D grid, the
// rectangle found from the block index; the tiles' columns aligned to the
// block's 32-column lattice, as nsum2d's are), and a tile writes only its
// cells inside its rectangle.  A tile runs the tile body of nsum2d
// (stencil_tile.cuh): it stages its (32+2eps)^2 window of the frame in
// shared memory and sums every output in the order fixed by the stencil
// plan, which does not depend on where the tile sits.  So INTERIOR then RING
// (or ALL) gives exactly the bits of nsum2d on the same frame, which is the
// JAX package's contract for the fused path (tests/test_halo_fused.py).
// The ring's tiles are 32 wide across an eps-wide band, so they compute
// more cells than they keep; the ring is a few percent of a large block.
// Types: float or double, operand the state type or __nv_bfloat16.
//
// Plain C interface (loaded with ctypes by ops/_build.py and wrapped in
// ops/cuda_halo.py).  The entry point launches on the given stream,
// allocates nothing and returns cudaGetLastError() (0 = launched), or -1
// when eps, the shared-memory tile, the phase or the grid is beyond what the
// kernel supports.  These limits live here only; the wrapper turns -1 into a
// ValueError.

#include "stencil_tile.cuh"

#include <climits>

namespace {

using namespace nlheat;

enum Phase { ALL = 0, INTERIOR = 1, RING = 2 };

constexpr int MAX_RECTS = 4;

// The rectangles of one phase, in block coordinates, and the first tile
// (launch block) of each.  A rectangle's tiles start at row r0 and at
// column oc, c0 rounded down to a multiple of TILE_Y, so that a warp's row
// of outputs is one aligned 128-byte line; tiles_y is the tile count
// across the rectangle.
struct Rects {
  int n;
  int r0[MAX_RECTS], c0[MAX_RECTS], rows[MAX_RECTS], cols[MAX_RECTS];
  int oc[MAX_RECTS], tiles_y[MAX_RECTS];
  int first[MAX_RECTS + 1];
};

template <typename T, typename OpT, int MW>
__global__ void __launch_bounds__(THREADS)
split_nsum2d_kernel(const T* __restrict__ frame, T* __restrict__ out, int bx, int by, int eps,
                    const Plan plan, const Rects rects) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  const int wc = TILE_Y + 2 * eps;
  T* tile = reinterpret_cast<T*>(smem_raw);
  T* wbuf = tile + (TILE_X + 2 * eps) * wc;
  const int tx = threadIdx.x, ty = threadIdx.y;
  int r = 0;
  while (r + 1 < rects.n && static_cast<int>(blockIdx.x) >= rects.first[r + 1]) ++r;
  const int t = static_cast<int>(blockIdx.x) - rects.first[r];
  const int x0 = rects.r0[r] + (t / rects.tiles_y[r]) * TILE_X;
  const int y0 = rects.oc[r] + (t % rects.tiles_y[r]) * TILE_Y;
  const int x1 = rects.r0[r] + rects.rows[r];
  const int c0 = rects.c0[r], y1 = c0 + rects.cols[r];

  // output (x, y) reads frame rows x .. x+2eps, columns y .. y+2eps
  load_window<T, OpT>(tile, wc, TILE_X + 2 * eps, wc, frame, bx + 2 * eps, by + 2 * eps, x0,
                      y0);
  __syncthreads();
  T acc[ROWS_PER_THREAD];
  window_sums<T, MW>(tile, wc, eps, plan, wbuf, acc);

#pragma unroll
  for (int k = 0; k < ROWS_PER_THREAD; ++k) {
    const int x = x0 + ty + k * THREADS_Y, y = y0 + tx;
    if (x < x1 && y >= c0 && y < y1) out[static_cast<size_t>(x) * by + y] = acc[k];
  }
}

// The rectangles of a phase; false when the phase does not apply (a
// degenerate block has no interior or ring).
bool phase_rects(int phase, int bx, int by, int eps, Rects& R) {
  R = Rects{};
  auto add = [&](int r0, int c0, int rows, int cols) {
    if (rows <= 0 || cols <= 0) return;
    R.r0[R.n] = r0;
    R.c0[R.n] = c0;
    R.rows[R.n] = rows;
    R.cols[R.n] = cols;
    ++R.n;
  };
  const int e = eps;
  const bool degen = bx <= 2 * e || by <= 2 * e;
  if (phase == ALL) {
    add(0, 0, bx, by);
  } else if (phase == INTERIOR && !degen) {
    add(e, e, bx - 2 * e, by - 2 * e);
  } else if (phase == RING && !degen) {
    add(0, 0, e, by);               // top band: block rows [0, e)
    add(bx - e, 0, e, by);          // bottom band: rows [bx-e, bx)
    add(e, 0, bx - 2 * e, e);       // left band: middle rows, columns [0, e)
    add(e, by - e, bx - 2 * e, e);  // right band: middle rows, columns [by-e, by)
  } else {
    return false;
  }
  long long total = 0;
  for (int i = 0; i < R.n; ++i) {
    R.first[i] = static_cast<int>(total);
    R.oc[i] = R.c0[i] / TILE_Y * TILE_Y;
    R.tiles_y[i] = (R.c0[i] + R.cols[i] - R.oc[i] + TILE_Y - 1) / TILE_Y;
    total += static_cast<long long>((R.rows[i] + TILE_X - 1) / TILE_X) * R.tiles_y[i];
    if (total > INT_MAX) return false;
  }
  R.first[R.n] = static_cast<int>(total);
  return true;
}

template <typename T, typename OpT, int MW>
int launch_mw(const void* frame, void* out, int bx, int by, int eps, const Rects& R,
              void* stream) {
  const size_t smem = tile_smem_bytes<T>(eps);
  auto kernel = split_nsum2d_kernel<T, OpT, MW>;
  const int e = allow_smem(kernel, smem);
  if (e != 0) return e;
  kernel<<<static_cast<unsigned>(R.first[R.n]), dim3(TILE_Y, THREADS_Y), smem,
           static_cast<cudaStream_t>(stream)>>>(static_cast<const T*>(frame),
                                                static_cast<T*>(out), bx, by, eps,
                                                make_plan(eps), R);
  return static_cast<int>(cudaGetLastError());
}

template <typename T, typename OpT>
int launch(const void* frame, void* out, int bx, int by, int eps, int phase, void* stream) {
  if (eps < 0 || eps > MAX_EPS) return -1;
  if (tile_smem_bytes<T>(eps) > static_cast<size_t>(smem_limit())) return -1;
  if (bx <= 0 || by <= 0) return 0;
  Rects R;
  if (!phase_rects(phase, bx, by, eps, R)) return -1;
  if (R.n == 0) return 0;
  return with_mw(eps, [&](auto mw) {
    return launch_mw<T, OpT, decltype(mw)::value>(frame, out, bx, by, eps, R, stream);
  });
}

template <typename T>
int split_typed(int bf16, const void* frame, void* out, int bx, int by, int eps, int phase,
                void* stream) {
  auto fn = bf16 ? &launch<T, __nv_bfloat16> : &launch<T, T>;
  return fn(frame, out, bx, by, eps, phase, stream);
}

}  // namespace

// dtype: 0 = float32, 1 = float64.  bf16: 1 selects the bfloat16 operand tier.
// phase: 0 = the whole block, 1 = the interior, 2 = the ring.
extern "C" int nlheat_split_nsum2d(int dtype, int bf16, const void* frame, void* out, int bx,
                                   int by, int eps, int phase, void* stream) {
  if (dtype == 0) return split_typed<float>(bf16, frame, out, bx, by, eps, phase, stream);
  if (dtype == 1) return split_typed<double>(bf16, frame, out, bx, by, eps, phase, stream);
  return -1;
}
