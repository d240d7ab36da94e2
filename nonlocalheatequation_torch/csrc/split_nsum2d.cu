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
//   INTERIOR  a rectangle of the block whose sums need no halo cell, and
//             which, on the walk, stages none: it reads the frame's block
//             cells only, so that it may run while the halo is still being
//             filled;
//   RING      the rest of the block, as four rectangles around it (top and
//             bottom full width, left and right on the interior's rows);
//   ALL       the whole block in one pass (a block with a side <= 2eps has no
//             interior: _degenerate, pallas_halo.py:409).
// INTERIOR then RING covers the block once.  Every output adds its terms in
// the stencil plan's order whatever tile it sits in, so any partition gives
// the same bits: INTERIOR then RING (or ALL) is exactly nsum2d on the same
// frame, which is the JAX package's contract for the fused path
// (tests/test_halo_fused.py).  (The TPU frame's `pad` rows of roll slack
// below it are not needed here.)
//
// What bounds it on an H100 SXM (NVIDIA's published peaks at the card's
// 700 W limit: 3.35 TB/s HBM3, 67 TFLOP/s f32 outside the tensor cores;
// computed bounds, not measurements): the function reads the frame once and
// writes the block once, 2 x 16 MiB for a 2048^2 f32 block at eps=8, about
// 10 us; the sums' 41 adds per point (about 2.6 us at the f32 peak) keep it
// bound by bytes.
//
// Design, for 0 <= eps <= REG_TILES_MAX_EPS (16): nsum2d's register walk
// (stencil_tile.cuh: reg_walk, stage_frame, register_sums; eps a template
// parameter, RUN*4 x 32 tiles, RUN = 32 in float32 and 16 in float64, each
// window staged by cp.async, double-buffered, 16 bytes a copy where the
// frame's base and row pitch, the window's row width and the span's column
// edges it meets are 16-byte aligned, else a value a copy).  The phases
// are cut on the walk's lattice from the block's origin: on each axis the
// interior is the lattice tiles whose windows lie inside the block,
// [T*ceil(eps/T), T*floor((b-eps)/T)) for tile length T, so that the two
// launches run exactly the one-pass lattice's tiles, none twice (1024 at the
// 2048^2 f32 block, eps=8: 868 interior, 156 ring); on an axis too short for
// such a tile the interior falls back to [eps, b-eps) and a tile writes only
// its cells inside its rectangle.  The interior's stage reads the frame's
// block cells only ([eps, b+eps) per axis; the cells beyond, which no
// output of the interior reads, are zero-filled).  Above eps 16, and on a
// block whose lattice has fewer tiles than the card has SMs (split_too_few:
// a 512^2 float32 block has 64, a 2048^2 one 1024), the phases are [eps,
// b-eps) and the four eps-wide bands around it, and a block of 32 x 8
// threads runs the tile body (load_window, window_sums) on a 32 x 32 output
// tile, its columns aligned to the block's 32-column lattice, the ring's
// tiles 32 wide across an eps-wide band.  Types: float or double, operand
// the state type or __nv_bfloat16.
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
// (launch block) of each.  A rectangle's tiles start at column oc, c0
// rounded down to a multiple of the tile width, so that a warp's row of
// outputs is one aligned 128-byte line, and at row r0 (the tile body) or r0
// rounded down to the walk's lattice; tiles_y is the tile count across the
// rectangle.
struct Rects {
  int n;
  int r0[MAX_RECTS], c0[MAX_RECTS], rows[MAX_RECTS], cols[MAX_RECTS];
  int oc[MAX_RECTS], tiles_y[MAX_RECTS];
  int first[MAX_RECTS + 1];
};

// The rectangle of the walk's tile t and the tile's output origin.
template <int ROWS, int COLS>
__device__ inline int walk_tile(const Rects& rects, int t, int& x0, int& y0) {
  int r = 0;
  while (r + 1 < rects.n && t >= rects.first[r + 1]) ++r;
  t -= rects.first[r];
  x0 = rects.r0[r] / ROWS * ROWS + (t / rects.tiles_y[r]) * ROWS;
  y0 = rects.oc[r] + (t % rects.tiles_y[r]) * COLS;
  return r;
}

// -- the register walk (stencil_tile.cuh, reg_walk), eps 0-16 ---------------------

// output (x, y) reads frame rows x .. x+2eps, columns y .. y+2eps: the window
// of the tile at (x0, y0) starts at frame cell (x0, y0); span is what the
// stage may read
template <typename T, typename OpT, int EPS>
__global__ void __launch_bounds__(REG_THREADS)
split_nsum2d_fast(const T* __restrict__ frame, T* __restrict__ out, int by, const Span2 span,
                  bool vec, const Rects rects) {
  constexpr int RUN = RegTile<T>::RUN, ROWS = RegTile<T>::ROWS, COLS = RegTile<T>::COLS;
  const int L = by + 2 * EPS;
  const int r0 = threadIdx.y * RUN;
  reg_walk<T, OpT, EPS>(
      rects.first[rects.n],
      [&](T* buf, long long t) {
        int x0, y0;
        walk_tile<ROWS, COLS>(rects, static_cast<int>(t), x0, y0);
        stage_frame<T, EPS>(buf, frame, L, span, x0, y0, vec);
      },
      [&](long long t, const T* /*col*/, const T (&acc)[RUN]) {
        int x0, y0;
        const int r = walk_tile<ROWS, COLS>(rects, static_cast<int>(t), x0, y0);
        const int y = y0 + threadIdx.x;
        if (y < rects.c0[r] || y >= rects.c0[r] + rects.cols[r]) return;
        const int x1 = rects.r0[r] + rects.rows[r];
#pragma unroll
        for (int k = 0; k < RUN; ++k) {
          const int x = x0 + r0 + k;
          if (x >= rects.r0[r] && x < x1) out[static_cast<size_t>(x) * by + y] = acc[k];
        }
      });
}

// -- the shared tile body (stencil_tile.cuh): eps above REG_TILES_MAX_EPS and
// small blocks (split_too_few) ----------------------------------------------------

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

// The interior on one axis of block length b: with tiles of length t (the
// walk's lattice), the lattice tiles whose windows lie in the block, else
// (t == 0, or no such tile) [eps, b - eps).  True for the lattice's.
bool interior_axis(int b, int eps, int t, int& lo, int& hi) {
  if (t > 0) {
    lo = (eps + t - 1) / t * t;
    hi = (b - eps) / t * t;
    if (lo < hi) return true;
  }
  lo = eps;
  hi = b - eps;
  return false;
}

// The rectangles of a phase for tiles of th x tw outputs, the interior on
// the walk's lattice (walk) or [eps, b-eps); false when the phase does not
// apply (a degenerate block has no interior or ring) or the grid is too big.
bool phase_rects(int phase, int bx, int by, int eps, int th, int tw, bool walk, Rects& R) {
  R = Rects{};
  auto add = [&](int r0, int c0, int rows, int cols) {
    if (rows <= 0 || cols <= 0) return;
    R.r0[R.n] = r0;
    R.c0[R.n] = c0;
    R.rows[R.n] = rows;
    R.cols[R.n] = cols;
    ++R.n;
  };
  int lx, hx, ly, hy;
  interior_axis(bx, eps, walk ? th : 0, lx, hx);
  interior_axis(by, eps, walk ? tw : 0, ly, hy);
  const bool degen = bx <= 2 * eps || by <= 2 * eps;
  if (phase == ALL) {
    add(0, 0, bx, by);
  } else if (phase == INTERIOR && !degen) {
    add(lx, ly, hx - lx, hy - ly);
  } else if (phase == RING && !degen) {
    add(0, 0, lx, by);              // top: block rows [0, lx)
    add(hx, 0, bx - hx, by);        // bottom: rows [hx, bx)
    add(lx, 0, hx - lx, ly);        // left: the interior's rows, columns [0, ly)
    add(lx, hy, hx - lx, by - hy);  // right: the interior's rows, columns [hy, by)
  } else {
    return false;
  }
  long long total = 0;
  for (int i = 0; i < R.n; ++i) {
    R.first[i] = static_cast<int>(total);
    R.oc[i] = R.c0[i] / tw * tw;
    R.tiles_y[i] = (R.c0[i] + R.cols[i] - R.oc[i] + tw - 1) / tw;
    const int orow = walk ? R.r0[i] / th * th : R.r0[i];  // as walk_tile's
    total += static_cast<long long>((R.r0[i] + R.rows[i] - orow + th - 1) / th) * R.tiles_y[i];
    if (total > INT_MAX) return false;
  }
  R.first[R.n] = static_cast<int>(total);
  return true;
}

template <typename T, typename OpT, int EPS>
int launch_fast(const void* frame, void* out, int bx, int by, int phase, cudaStream_t stream) {
  constexpr int ROWS = RegTile<T>::ROWS, COLS = RegTile<T>::COLS;
  Rects R;
  if (!phase_rects(phase, bx, by, EPS, ROWS, COLS, true, R)) return -1;
  if (R.n == 0) return 0;
  // the interior stages the frame's block cells only; its windows meet the
  // span's column edges only where the interior's columns fell back to
  // [eps, by-eps)
  int lo, hi;
  const bool lattice_y = interior_axis(by, EPS, COLS, lo, hi);
  const Span2 span = phase == INTERIOR ? Span2{EPS, bx + EPS, EPS, by + EPS}
                                       : Span2{0, bx + 2 * EPS, 0, by + 2 * EPS};
  const bool vec = stage_frame_vec<T, EPS>(frame, by + 2 * EPS, span,
                                           phase != INTERIOR || !lattice_y);
  static int per_sm = -1;  // blocks an SM holds, asked once per instantiation
  return reg_tiles_launch<T, EPS>(split_nsum2d_fast<T, OpT, EPS>, R.first[R.n], per_sm, stream,
                                  static_cast<const T*>(frame), static_cast<T*>(out), by, span,
                                  vec, R);
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

// Whether a block is too small for the walk: its lattice of RUN*4 x 32 tiles
// has fewer tiles than the card has SMs, so each phase leaves SMs idle for
// the length of one tile, where the tile body's 32 x 32 blocks fill the
// card.  From chip_smoke.py --ab halo2d on an H100 (132 SMs), eps=8, per
// call in a CUDA graph against the tile body: float32 256^2 (16 tiles) and
// 512^2 (64) 37% and 29% slower, 1024^2 (256) 29% faster; float64 256^2
// (32) 8% slower, 512^2 (128) 3% faster, 1024^2 (512) 19% faster
// (PERF.md section 6).  Both phases of a call take the same design, so
// they cut the block the same way.
template <typename T>
bool split_too_few(int bx, int by) {
  static const int sms = device_attr(cudaDevAttrMultiProcessorCount);
  const long long tiles = static_cast<long long>((bx + RegTile<T>::ROWS - 1) / RegTile<T>::ROWS) *
                          ((by + RegTile<T>::COLS - 1) / RegTile<T>::COLS);
  return tiles < sms;
}

// The register walk where eps and the block allow it, else the tile body.
template <typename T, typename OpT>
int launch(const void* frame, void* out, int bx, int by, int eps, int phase, void* stream) {
  if (eps < 0 || eps > MAX_EPS) return -1;
  if (tile_smem_bytes<T>(eps) > static_cast<size_t>(smem_limit())) return -1;
  if (bx <= 0 || by <= 0) return 0;
  if (eps <= REG_TILES_MAX_EPS && !split_too_few<T>(bx, by))
    return with_eps<REG_TILES_MAX_EPS>(eps, [&](auto e) {
      return launch_fast<T, OpT, decltype(e)::value>(frame, out, bx, by, phase,
                                                      static_cast<cudaStream_t>(stream));
    });
  Rects R;
  if (!phase_rects(phase, bx, by, eps, TILE_X, TILE_Y, false, R)) return -1;
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
