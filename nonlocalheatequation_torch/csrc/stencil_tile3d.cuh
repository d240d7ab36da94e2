// The tile body of the port's 3D kernels: the window load, the masked-sphere
// neighbour sum in its fixed summation order, and (from stencil_tile.cuh)
// the forward-Euler epilogue.
//
// Counterpart of _block_neighbor_sum_3d (nonlocalheatequation_tpu/ops/
// pallas_kernel.py:672), which the TPU's per-step, carried and resident 3D
// kernels share.  nsum3d.cu (nsum3d, step3d), carried3d.cu, resident3d.cu,
// split_nsum3d.cu and fused_nsum3d.cu run it above eps 6; below, all five
// run the register design at the end of this header (fast3_sums, its window
// staged from one source by fast3_stage or fast3_stage_chunks or, in
// fused_nsum3d.cu, from the blocks of a mesh), which adds the same terms in
// the same order, so every 3D kernel gives the bits of step3d and of the
// plain versions' sphere_sum (ops/cuda_kernel.py).
//
// The state is [x][y][z], z contiguous.  One block owns an output tile of
// TP x TP points in the (x, y) plane by TZ = 32 along z (one lane each) and
// stages its (TP+2eps) x (TP+2eps) x (32+2eps) window in shared memory.
//
// * The sum.  The sphere is a set of z-columns: column (i, j) of the plane
//   offsets with i^2 + j^2 <= eps^2 spans |k| <= h(i, j) =
//   trunc(sqrt(eps^2 - i^2 - j^2)) (49 columns at eps=4, 113 at eps=6).  For
//   every window line (a, b), W_h(a, b)[z] = sum_{|k|<=h} win[a][b][z+k]
//   grows in place in shared memory one pair of cells per height (5 distinct
//   heights at eps=4, 7 at eps=6), and at each height every output adds
//   W_h(x+i, y+j)[z] for the columns of that height.  That is 2 adds per
//   height per window cell and one add per column per output, against the
//   direct sum's 256 (eps=4) or 924 (eps=6) adds per output.  Every element
//   adds its terms in one fixed order (heights ascending, then columns by
//   (i, j) ascending; within W, centre then pairs outward) that depends
//   neither on where its tile sits nor on the tile's width TP, so every
//   kernel and every tile width gives the same bits.
// * The cost.  Each height is a read-modify-write of wbuf plus two window
//   reads over every window line-cell, and each output reads its columns'
//   W values from wbuf: about 127 shared-memory accesses per point at eps=4,
//   the 8 x 8 x 32 tile, with two barriers a height; step3d ran at 12.6x its
//   byte bound on this body at 256^3, eps=4, f32 (PERF.md), and 5.7x on the
//   register design.
// * The tile width.  The window grows as (TP+2eps)^2 (32+2eps), so TP is
//   the largest of 8, 4, 2, 1 whose window and sum buffer fit the block's
//   shared memory (f32: TP=8 up to eps=8, TP=1 at eps=12; f64: TP=8 up to
//   eps=4, TP=2 at eps=8).  Beyond TP=1 the kernels refuse (-1).
//
// The bf16 operand tier rounds each window cell to bfloat16 once, as it is
// loaded, and accumulates in the state type; the carry reads the unrounded
// centre.

#pragma once

#include "stencil_tile.cuh"

#include <climits>
#include <cstdint>

namespace nlheat {

constexpr int TZ = 32;           // output z (contiguous) per tile, one lane each
constexpr int TY3 = 8;           // thread rows (threadIdx.y)
constexpr int THREADS3 = TZ * TY3;
constexpr int MAX_EPS3 = 12;
constexpr int MAX_COLS3 = 448;   // 441 columns at eps=12

// The stencil plan, passed by value: the sphere's columns grouped by
// half-height h, (i, j) ascending within a group, each packed as
// (i << 8) | j with i, j in [0, 2eps].  Group h is col[hstart[h] ..
// hstart[h+1]).
struct Plan3 {
  int col[MAX_COLS3];
  int hstart[MAX_EPS3 + 2];
};

inline Plan3 make_plan3(int eps) {
  // h(i, j) = trunc(sqrt(eps^2 - i^2 - j^2)) in double:
  // ops/stencil.sphere_column_heights
  Plan3 p{};
  int n = 0;
  for (int h = 0; h <= eps; ++h) {
    p.hstart[h] = n;
    for (int i = 0; i <= 2 * eps; ++i)
      for (int j = 0; j <= 2 * eps; ++j) {
        const int rem = eps * eps - (i - eps) * (i - eps) - (j - eps) * (j - eps);
        if (rem >= 0 && static_cast<int>(std::sqrt(static_cast<double>(rem))) == h)
          p.col[n++] = (i << 8) | j;
      }
  }
  p.hstart[eps + 1] = n;
  return p;
}

// Where a launch's tiles sit.  Arrays are row-major [x][y][z].  The tiles
// form a lattice from org, tiles[] of them per axis, over the box [lo, lo +
// n) of output cells; the output cell (X, Y, Z) is the step (or sum) of the
// source cell (X, Y, Z) + shift.
struct Geom3 {
  int out[3];
  int src[3];
  int shift;
  int lo;
  int n[3];
  int org[3];
  int tiles[3];
};

// The cells a window load may read: [lo, hi[d]) on axis d of the source,
// the rest zero-filled.  A load of the whole source reads [0, src).
struct Span3 {
  int lo;
  int hi[3];
};

__host__ __device__ inline Span3 whole_source(const Geom3& g) {
  return {0, {g.src[0], g.src[1], g.src[2]}};
}

// Elements of shared memory a tile of plane width TP needs: the window and
// the sum buffer W, (TP+2eps)^2 lines of 32+2eps and of 32.
inline size_t tile3_elems(int eps, int tp) {
  const size_t lines = static_cast<size_t>(tp + 2 * eps) * (tp + 2 * eps);
  return lines * (TZ + 2 * eps) + lines * TZ;
}

// The plane width the kernels use for eps and an element size: the widest of
// 8, 4, 2, 1 that fits the block's shared memory, or 0 (refused).
inline int tile3_width(int eps, size_t elem) {
  if (eps < 0 || eps > MAX_EPS3) return 0;
  for (int tp = 8; tp >= 1; tp /= 2)
    if (tile3_elems(eps, tp) * elem <= static_cast<size_t>(smem_limit())) return tp;
  return 0;
}

// Instantiate f for the plane width tp: calls f(std::integral_constant<int, TP>{}).
template <typename F>
int with_tp(int tp, F f) {
  switch (tp) {
    case 8: return f(std::integral_constant<int, 8>{});
    case 4: return f(std::integral_constant<int, 4>{});
    case 2: return f(std::integral_constant<int, 2>{});
    case 1: return f(std::integral_constant<int, 1>{});
    default: return -1;
  }
}

// The tile lattice over the box [start, start + len) on one axis, with tile
// length t: the origin and the count.
struct Axis {
  int org, count;
};

inline Axis axis_over(int start, int len, int t) { return {start, (len + t - 1) / t}; }

__host__ __device__ inline long long tile_count(const Geom3& g) {
  return static_cast<long long>(g.tiles[0]) * g.tiles[1] * g.tiles[2];
}

// The output origin of tile t (z fastest).
__device__ inline void tile_origin(const Geom3& g, int t, int tp, int& x0, int& y0, int& z0) {
  const int tz = t % g.tiles[2];
  t /= g.tiles[2];
  const int ty = t % g.tiles[1];
  const int tx = t / g.tiles[1];
  x0 = g.org[0] + tx * tp;
  y0 = g.org[1] + ty * tp;
  z0 = g.org[2] + tz * TZ;
}

// Copy the window of the tile at output origin (x0, y0, z0) into shared
// memory: cell (a, b, c) is src[x0 - eps + shift + a][...][...], 0 outside
// the span (the whole source unless given), rounded to the operand type.
// Each thread row takes window lines (a, b), LOAD_LINES at a time, and each
// lane two z cells of a line (32 + 2eps <= 64): the loads of a batch are all
// issued before the first store, so a thread has 2*LOAD_LINES loads in
// flight.
constexpr int LOAD_LINES = 4;
static_assert(TZ + 2 * MAX_EPS3 <= 2 * TZ, "a window line is at most two cells per lane");

template <typename T, typename OpT, bool L2ONLY = false, typename S>
__device__ void load_window3(T* win, int wp, int wz, const S* src, const Geom3& g, int eps,
                             int x0, int y0, int z0, const Span3& span) {
  const int r0 = x0 - eps + g.shift, s0 = y0 - eps + g.shift;
  const int lines = wp * wp;
  const int ca = threadIdx.x, cb = threadIdx.x + TZ;  // this lane's z cells
  const int qa = z0 - eps + g.shift + ca, qb = qa + TZ;
  const bool za = qa >= span.lo && qa < span.hi[2],
             zb = cb < wz && qb >= span.lo && qb < span.hi[2];
  for (int l0 = threadIdx.y; l0 < lines; l0 += LOAD_LINES * TY3) {
    T va[LOAD_LINES], vb[LOAD_LINES];
#pragma unroll
    for (int k = 0; k < LOAD_LINES; ++k) {
      const int line = l0 + k * TY3;
      const int a = line / wp, b = line - a * wp;
      const int r = r0 + a, s = s0 + b;
      const bool ok = line < lines && r >= span.lo && r < span.hi[0] && s >= span.lo &&
                      s < span.hi[1];
      const S* row = src + (static_cast<size_t>(ok ? r : 0) * g.src[1] + (ok ? s : 0)) * g.src[2];
      va[k] = ok && za ? to_state<T>(load<L2ONLY>(row + qa)) : T(0);
      vb[k] = ok && zb ? to_state<T>(load<L2ONLY>(row + qb)) : T(0);
    }
#pragma unroll
    for (int k = 0; k < LOAD_LINES; ++k) {
      const int line = l0 + k * TY3;
      if (line < lines) {
        win[line * wz + ca] = Operand<T, OpT>::round(va[k]);
        if (cb < wz) win[line * wz + cb] = Operand<T, OpT>::round(vb[k]);
      }
    }
  }
}

template <typename T, typename OpT, bool L2ONLY = false, typename S>
__device__ void load_window3(T* win, int wp, int wz, const S* src, const Geom3& g, int eps,
                             int x0, int y0, int z0) {
  load_window3<T, OpT, L2ONLY>(win, wp, wz, src, g, eps, x0, y0, z0, whole_source(g));
}

// Output points per thread: the tile's TP*TP plane points dealt over the
// TY3 thread rows (point p = threadIdx.y + k*TY3).
template <int TP>
__host__ __device__ constexpr int points_per_thread() { return (TP * TP + TY3 - 1) / TY3; }

// The neighbour sums of one tile whose window starts at win in shared
// memory.  acc[k] is the sum for plane point threadIdx.y + k*TY3, z lane
// threadIdx.x.  wbuf holds (TP+2eps)^2 * TZ values.  Every thread of the
// block calls it (it holds barriers); it ends with a barrier, so the caller
// may overwrite wbuf or the window right after.
template <typename T, int TP>
__device__ void window_sums3(const T* win, int eps, const Plan3& plan, T* wbuf,
                             T (&acc)[points_per_thread<TP>()]) {
  constexpr int KP = points_per_thread<TP>();
  const int tx = threadIdx.x, ty = threadIdx.y;
  const int wp = TP + 2 * eps, wz = TZ + 2 * eps;
  const int lines = wp * wp;
  int base[KP];  // the window line of each of this thread's points
#pragma unroll
  for (int k = 0; k < KP; ++k) {
    const int p = ty + k * TY3;
    base[k] = (p / TP) * wp + p % TP;
    acc[k] = T(0);
  }
  bool read = false;  // whether the last height's W had readers
  for (int h = 0; h <= eps; ++h) {
    if (read) __syncthreads();  // the readers of W_{h-1} are done
    for (int line = ty; line < lines; line += TY3) {
      const T* cell = win + line * wz + tx + eps;
      T* w = wbuf + line * TZ + tx;
      if (h == 0) {
        *w = cell[0];
      } else {
        T v = *w;
        v = v + cell[-h];
        v = v + cell[h];
        *w = v;
      }
    }
    const int p0 = plan.hstart[h], p1 = plan.hstart[h + 1];
    read = p0 != p1;  // uniform over the block
    if (!read) continue;
    __syncthreads();  // W_h is written everywhere
    for (int p = p0; p < p1; ++p) {
      const int col = plan.col[p];
      const int off = (col >> 8) * wp + (col & 255);
#pragma unroll
      for (int k = 0; k < KP; ++k)
        if (ty + k * TY3 < TP * TP) acc[k] = acc[k] + wbuf[(base[k] + off) * TZ + tx];
    }
  }
  __syncthreads();
}

// The launch geometry of a step over the interior of an unpadded state
// (step3d, nsum3d), of a frame read at shift eps (carried3d) or of a frame's
// interior (resident3d): shift and lo as given, the interior tiled from lo.
inline Geom3 interior_geom(const int out[3], const int src[3], int shift, int lo,
                           const int n[3], int tp) {
  Geom3 g{};
  const int len[3] = {tp, tp, TZ};
  for (int d = 0; d < 3; ++d) {
    g.out[d] = out[d];
    g.src[d] = src[d];
    g.n[d] = n[d];
    const Axis a = axis_over(lo, n[d], len[d]);
    g.org[d] = a.org;
    g.tiles[d] = a.count;
  }
  g.shift = shift;
  g.lo = lo;
  return g;
}

// -- the register design (nsum3d.cu: nsum3d, step3d; carried3d.cu; resident3d.cu;
// split_nsum3d.cu; fused_nsum3d.cu), eps 0-6 ------------------------------------------
//
// A block of 32 x TP threads owns a TP x TP x 32 output tile (TP = 8 in
// float32; in float64 8 up to eps=4, then 4) and stages its (TP+2eps)^2 x
// (32+2eps) window by cp.async, the cells outside the source zero-filled by
// the copy itself: 16 bytes a copy where the source's rows and the window's
// z origin fall on 16-byte boundaries, else 8 bytes where they fall on
// 8-byte ones (fast3_chunk: eps=6 in float32 from an unpadded state), else
// one cell a copy.  A window line may be staged with a longer pitch LP (a
// template parameter, TZ + 2eps by default): resident3d.cu pads its lines to
// 16 bytes so that every copy is 16 bytes, and the cells past TZ + 2eps are
// staged but never summed.
// Thread (z lane, row x) owns the window rows x + TP*m, every line of them,
// and the TP outputs (x, 0 .. TP-1) of its lane.  It advances W_h of its
// lines in registers (two window reads a height, only for the lines a column
// of that height or above can reach) and writes W_h to one of two W buffers
// in shared memory, by the parity of h, so one barrier a height separates
// the writers from the readers.  Each output row then reads W_h of window
// row x + i into registers once and adds it over every column (i, j) of
// height h and every output of the row: about 29 W reads a point at eps=4
// against 49 adds.  eps is a template parameter, so every offset is a
// constant and every register index fixed.  Shared-memory accesses per point
// at eps=4, f32: about 5 (staging) + 23 (window reads) + 13 (W writes) + 29
// (W reads), 70 in all, against the tile body's 127.  Up to eps=4 in float32
// two blocks share an SM (104 KB each), so one block's load overlaps the
// other's sums; the second W buffer takes the room a second, prefetched
// window would need.  In the bf16 tier the block rounds its staged window in
// place once.  The terms and their order are the tile body's (above), so
// both designs give the same bits.

constexpr int FAST_MAX_EPS3 = 6;
constexpr size_t FAST3_FULL = 232448;  // the shared memory a block may opt in to on an H100

// whether the column (i, j) of the plane offsets [0, 2eps]^2 has half-height
// h: trunc(sqrt(eps^2 - (i-eps)^2 - (j-eps)^2)) == h, without the sqrt
__host__ __device__ constexpr bool col_is(int eps, int h, int i, int j) {
  const int rem = eps * eps - (i - eps) * (i - eps) - (j - eps) * (j - eps);
  return rem >= h * h && rem < (h + 1) * (h + 1);
}

__host__ __device__ constexpr bool height_has_cols(int eps, int h) {
  for (int i = 0; i <= 2 * eps; ++i)
    for (int j = 0; j <= 2 * eps; ++j)
      if (col_is(eps, h, i, j)) return true;
  return false;
}

// Elements of shared memory a tile of plane width tp needs: the window,
// (tp+2eps)^2 lines of lp cells (32+2eps unless padded), and two W buffers of
// (tp+2eps)^2 lines of 32.
__host__ __device__ constexpr size_t fast3_elems(int eps, int tp, int lp) {
  return static_cast<size_t>(tp + 2 * eps) * (tp + 2 * eps) * (lp + 2 * TZ);
}

__host__ __device__ constexpr size_t fast3_elems(int eps, int tp) {
  return fast3_elems(eps, tp, TZ + 2 * eps);
}

// The plane width: the widest of 8, 4, 2, 1 whose tile fits a block's shared
// memory, or 0.
template <typename T, int EPS, int LP = TZ + 2 * EPS>
__host__ __device__ constexpr int fast3_tp() {
  for (int tp = 8; tp >= 1; tp /= 2)
    if (fast3_elems(EPS, tp, LP) * sizeof(T) <= FAST3_FULL) return tp;
  return 0;
}

template <int EPS, int TP, int LP = TZ + 2 * EPS>
struct Fast3 {
  static constexpr int WP = TP + 2 * EPS;               // window lines a side
  static constexpr int WZ = LP;                         // the pitch of a window line
  static constexpr int LINES = WP * WP;
  static constexpr int NR = (WP + TP - 1) / TP;         // window rows a thread owns
  static_assert(NR * WP <= 64, "the W registers of a thread");
  static_assert(LP >= TZ + 2 * EPS, "a window line holds its 32 + 2eps cells");
};

// Heights H .. EPS of the sums (steps 1 and 2 of the order above).  Thread
// (z lane tx, row ty) owns window rows ty + TP*m, every line (a, b) of them,
// and the outputs (ty, 0 .. TP-1) of its lane.  It grows W_H of its lines in
// registers, for the lines within reach of a column of height >= H, and
// writes them to the W buffer of H's parity when a column has height H;
// after one barrier each output adds W_H over those columns, (i, j)
// ascending: row i's W values are read into registers once and serve every
// j and every output of the row.  The line b of a row is a constant, so
// every offset is.
template <typename T, int EPS, int TP, int H, int LP = TZ + 2 * EPS>
__device__ __forceinline__ void sums3_from(const T* win, T* wbuf,
                                           T (&W)[Fast3<EPS, TP>::NR * Fast3<EPS, TP>::WP],
                                           T (&acc)[TP]) {
  using F = Fast3<EPS, TP, LP>;
  constexpr int R = isqrt(EPS * EPS - H * H);  // columns of height >= H reach R from the centre
  constexpr bool READ = height_has_cols(EPS, H);
  constexpr bool PREV = H > 0 && height_has_cols(EPS, H - 1);
  const int tx = threadIdx.x, ty = threadIdx.y;
  T* wb = wbuf + (H & 1) * F::LINES * TZ;
#pragma unroll
  for (int m = 0; m < F::NR; ++m) {
    const int a = ty + TP * m;
    if (a < F::WP && a >= EPS - R && a < TP + EPS + R) {  // uniform over the warp
      const T* c = win + a * F::WP * F::WZ + tx + EPS;
      T* w = wb + a * F::WP * TZ + tx;
#pragma unroll
      for (int b = EPS - R; b < TP + EPS + R; ++b) {
        T& v = W[m * F::WP + b];
        if constexpr (H == 0) {
          v = c[b * F::WZ];
        } else {
          v = v + c[b * F::WZ - H];
          v = v + c[b * F::WZ + H];
        }
        if constexpr (READ) w[b * TZ] = v;
      }
    }
  }
  // W_H is written everywhere; and the readers of the buffer H+1 writes
  // (last read at H-1) are done
  if constexpr (READ || PREV) __syncthreads();
  if constexpr (READ) {
    const T* wrow = wb + ty * F::WP * TZ + tx;
#pragma unroll
    for (int i = 0; i <= 2 * EPS; ++i) {
      T w[F::WP];  // W_H of window row ty + i; the loads no column uses are dropped
#pragma unroll
      for (int b = 0; b < F::WP; ++b) w[b] = wrow[(i * F::WP + b) * TZ];
#pragma unroll
      for (int j = 0; j <= 2 * EPS; ++j) {
        if (col_is(EPS, H, i, j)) {
#pragma unroll
          for (int r = 0; r < TP; ++r) acc[r] = acc[r] + w[r + j];
        }
      }
    }
  }
  if constexpr (H < EPS) sums3_from<T, EPS, TP, H + 1, LP>(win, wbuf, W, acc);
}

// The window line of eps padded to a whole number of 16-byte copies.
template <typename T, int EPS>
__host__ __device__ constexpr int line16() {
  return (TZ + 2 * EPS + vec_width<T>() - 1) / vec_width<T>() * vec_width<T>();
}

// Eight bytes (two float32 values) from global to shared memory, both
// 8-byte aligned; valid == false fills zeros and reads nothing.
__device__ inline void cp_async_8(void* dst, const void* src, bool valid) {
  const unsigned s = static_cast<unsigned>(__cvta_generic_to_shared(dst));
  asm volatile("cp.async.ca.shared.global [%0], [%1], 8, %2;\n" ::"r"(s), "l"(src),
               "r"(valid ? 8 : 0) : "memory");
}

// C values (16 bytes, 8 bytes or one value) from global to shared memory.
template <typename T, int C>
__device__ __forceinline__ void cp_async_chunk(T* dst, const T* src, bool valid) {
  if constexpr (C * sizeof(T) == 16)
    cp_async_16(dst, src, valid);
  else if constexpr (C > 1)
    cp_async_8(dst, src, valid);
  else
    cp_async_value(dst, src, valid);
}

// The values a stage of geometry g copies at once: the widest of 16 and 8
// bytes whose chunks are aligned and lie wholly inside or outside the span
// (the window's lines and z origins, z0 - EPS + shift with z0 a multiple of
// 32, the source's rows and the span's z edges all on chunk boundaries),
// else one value.
template <typename T, int EPS>
inline int fast3_chunk(const Geom3& g, const void* src, const Span3& span) {
  for (int c = vec_width<T>(); c > 1; c /= 2)
    if ((TZ + 2 * EPS) % c == 0 && (g.shift - EPS) % c == 0 && g.src[2] % c == 0 &&
        span.lo % c == 0 && span.hi[2] % c == 0 &&
        reinterpret_cast<uintptr_t>(src) % (c * sizeof(T)) == 0)
      return c;
  return 1;
}

template <typename T, int EPS>
inline int fast3_chunk(const Geom3& g, const void* src) {
  return fast3_chunk<T, EPS>(g, src, whole_source(g));
}

// Call stage(std::integral_constant<int, C>{}) for C = chunk: vec_width<T>(),
// 2 (float32 only) or 1.
template <typename T, typename F>
__device__ __forceinline__ void with_chunk(int chunk, F stage) {
  constexpr int V = vec_width<T>();
  if (chunk == V)
    stage(std::integral_constant<int, V>{});
  else if (V > 2 && chunk == 2)
    stage(std::integral_constant<int, (V > 2 ? 2 : 1)>{});
  else
    stage(std::integral_constant<int, 1>{});
}

// The frame stage at C values a copy: start the cp.async copies of the
// window of the tile at output origin (x0, y0, z0) into win, LP cells a line:
// cell (a, b, c) is src[x0 - EPS + shift + a][...][...], 0 outside the span,
// consecutive threads on consecutive cells.  The chunks must be aligned and
// lie wholly inside or outside the span (fast3_chunk's conditions for the
// line pitch LP).
template <typename T, int EPS, int TP, int C, int LP = TZ + 2 * EPS>
__device__ __forceinline__ void fast3_stage_chunks(T* win, const T* src, const Geom3& g,
                                                   const Span3& span, int x0, int y0, int z0) {
  using F = Fast3<EPS, TP, LP>;
  constexpr int PER_LINE = F::WZ / C;  // whole where C is the stage's chunk
  const int r0 = x0 - EPS + g.shift, s0 = y0 - EPS + g.shift, q0 = z0 - EPS + g.shift;
  for (int idx = threadIdx.y * TZ + threadIdx.x; idx < F::LINES * PER_LINE; idx += TZ * TP) {
    const int l = idx / PER_LINE, c = (idx - l * PER_LINE) * C;
    const int a = l / F::WP, b = l - a * F::WP;
    const int r = r0 + a, s = s0 + b, q = q0 + c;
    const bool ok = r >= span.lo && r < span.hi[0] && s >= span.lo && s < span.hi[1] &&
                    q >= span.lo && q < span.hi[2];
    const T* from = ok ? src + (static_cast<size_t>(r) * g.src[1] + s) * g.src[2] + q : src;
    cp_async_chunk<T, C>(win + l * F::WZ + c, from, ok);
  }
}

// The same at `chunk` values a copy (fast3_chunk, from the host).
template <typename T, int EPS, int TP>
__device__ __forceinline__ void fast3_stage(T* win, const T* __restrict__ src, const Geom3& g,
                                            const Span3& span, int chunk, int x0, int y0,
                                            int z0) {
  with_chunk<T>(chunk, [&](auto cc) {
    fast3_stage_chunks<T, EPS, TP, decltype(cc)::value>(win, src, g, span, x0, y0, z0);
  });
}

// The register design's tile with its window staged by stage(win), a
// callable that issues the cp.async copies of the window (cell (a, b, c) at
// win[(a * WP + b) * WZ + c]): wait for them, round the window to the
// operand type in place, and sum it: acc[r] is the neighbour sum of the
// tile's output (threadIdx.y, r, threadIdx.x).  Returns the window in shared
// memory, which stays as staged (fast3_centre reads it).  Every thread of
// the 32 x TP block calls it (it holds barriers).  The sums are one body for
// every stage: the frame's (fast3_tile) and the mesh's (fused_nsum3d.cu).
template <typename T, typename OpT, int EPS, int TP, int LP = TZ + 2 * EPS, typename Stage>
__device__ __forceinline__ const T* fast3_sums(Stage stage, T (&acc)[TP]) {
  using F = Fast3<EPS, TP, LP>;
  extern __shared__ __align__(16) unsigned char smem_raw[];
  T* win = reinterpret_cast<T*>(smem_raw);
  T* wbuf = win + F::LINES * F::WZ;
  stage(win);
  cp_async_commit();
  cp_async_wait<0>();
  __syncthreads();
  if constexpr (!std::is_same<T, OpT>::value) {
    for (int idx = threadIdx.y * TZ + threadIdx.x; idx < F::LINES * F::WZ; idx += TZ * TP)
      win[idx] = Operand<T, OpT>::round(win[idx]);
    __syncthreads();
  }

  T W[F::NR * F::WP];
#pragma unroll
  for (int r = 0; r < TP; ++r) acc[r] = T(0);
  sums3_from<T, EPS, TP, 0, LP>(win, wbuf, W, acc);
  return win;
}

// The tile at output origin (x0, y0, z0) staged from one source (cell (a,
// b, c) is src[x0 - EPS + shift + a][...][...], 0 outside the source) and
// summed: acc[r] is the neighbour sum of output (x0 + threadIdx.y, y0 + r,
// z0 + threadIdx.x).
template <typename T, typename OpT, int EPS, int TP>
__device__ __forceinline__ const T* fast3_tile(const T* __restrict__ src, const Geom3& g,
                                               int chunk, int x0, int y0, int z0,
                                               T (&acc)[TP]) {
  return fast3_sums<T, OpT, EPS, TP>(
      [&](T* win) {
        fast3_stage<T, EPS, TP>(win, src, g, whole_source(g), chunk, x0, y0, z0);
      },
      acc);
}

// The staged (operand) value of output (x0 + threadIdx.y, y0 + r, z0 +
// threadIdx.x) in the window fast3_tile returned.
template <int EPS, int TP, int LP = TZ + 2 * EPS, typename T>
__device__ __forceinline__ T fast3_centre(const T* win, int r) {
  using F = Fast3<EPS, TP, LP>;
  return win[((threadIdx.y + EPS) * F::WP + r + EPS) * F::WZ + threadIdx.x + EPS];
}

// Launch kernel, a register-design kernel of plane width TP, on `tiles`
// blocks of 32 x TP threads, one tile each; -1 when its shared memory or
// grid is beyond the card, else the CUDA status.
template <typename T, int EPS, int TP, typename Kernel, typename... Args>
int fast3_launch_n(Kernel kernel, long long tiles, cudaStream_t stream, Args... args) {
  static_assert(TP > 0, "every eps of the register design fits a block");
  const size_t smem = fast3_elems(EPS, TP) * sizeof(T);
  if (smem > static_cast<size_t>(smem_limit())) return -1;
  if (tiles > INT_MAX) return -1;
  const int e = allow_smem(kernel, smem);
  if (e != 0) return e;
  kernel<<<static_cast<unsigned>(tiles), dim3(TZ, TP), smem, stream>>>(args...);
  return static_cast<int>(cudaGetLastError());
}

// The same over every tile of g.
template <typename T, int EPS, int TP, typename Kernel, typename... Args>
int fast3_launch(Kernel kernel, const Geom3& g, cudaStream_t stream, Args... args) {
  return fast3_launch_n<T, EPS, TP>(kernel, tile_count(g), stream, args...);
}

}  // namespace nlheat
