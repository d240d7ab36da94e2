// The split neighbour sum of one block of a distributed 3D solve, from its
// filled halo frame, for NVIDIA Hopper (sm_90a).
//
// Replaces the Pallas TPU kernel of nonlocalheatequation_tpu
//   split_nsum3d  <- ops/pallas_halo.py:build_split_nsum_3d (body
//                    _nsum_phases_3d :363): the 3D compute body of the fused
//                    halo kernel, the exchange factored out
// The frame is (bx+2eps, by+2eps, bz+2eps), row-major [x][y][z], its halo
// already filled (parallel/halo.py); the output is the (bx, by, bz) sum over
// the masked sphere.  One launch computes one phase:
//   INTERIOR  a box of the block whose sums need no halo cell, and which
//             stages none: it reads the frame's block cells only, so that
//             it may run while the halo is still being filled;
//   RING      the rest of the block, as six slabs around that box (x slabs
//             full face, y slabs on the box's x rows, z slabs on its xy
//             core);
//   ALL       the whole block in one pass (a side <= 2eps: no interior).
// INTERIOR then RING covers the block once.  The partition is this kernel's
// own: the JAX package's _nsum_phases_3d (and the plain version,
// ops/cuda_halo.split_nsum3d_plain) takes the box [eps, b-eps) and eps-wide
// slabs.  Here the box is, on each axis, the tiles of nsum3d's lattice
// (TP x TP x 32 from the block's origin) whose windows lie inside the block,
// [TP*ceil(eps/TP), TP*floor((b-eps)/TP)) in x and y and the same with 32 in
// z, so that the two phases launch exactly the one-pass lattice's tiles
// (1024 at the 128^3 f32 block, eps=4: 392 interior, 632 ring); on an axis
// too short for such a tile it falls back to [eps, b-eps).  Every output
// adds its terms in the stencil plan's order whatever tile it sits in, so
// any partition gives the same bits: INTERIOR then RING (or ALL) is exactly
// nsum3d on the same frame.
//
// What bounds it on an H100 SXM (NVIDIA's published peaks at the card's
// 700 W limit; computed bounds, not measurements): the function reads the
// frame once and writes the block once, about 2 x 8 MiB for a 128^3 f32
// block at eps=4, about 5 us; the sums' 81 adds per point at eps=4 put its
// operations near 2.5 us, so bytes bound it, and the shared-memory work of
// the sums sets its time (as nsum3d's).
//
// Design.  Each phase is a list of up to six boxes of the output; one
// launch covers every tile of each box (a 1D grid, the box found from the
// block index; the tiles on nsum3d's lattice), and a tile writes only its
// cells inside its box.  For 0 <= eps <= FAST_MAX_EPS3 (6) a tile runs
// nsum3d's register design (stencil_tile3d.cuh: fast3_stage, fast3_sums;
// eps a template parameter, a 32 x TP block, the window staged by cp.async,
// 16 bytes a copy where the frame's rows, the window's z origin and the
// staged span's z edges are aligned (else 8 bytes, else a value), W_h in
// registers, one barrier a height).  The interior's stage reads the span of
// the frame's block cells only ([eps, b+eps) per axis; the cells beyond,
// which no output of the box reads, are zero-filled).  Above eps 6 a tile
// runs the shared tile body (load_window3 over the same span, window_sums3),
// which gives the same bits.  Types: float or double, operand the state type
// or __nv_bfloat16.
//
// Plain C interface (loaded with ctypes by ops/_build.py and wrapped in
// ops/cuda_halo.py).  The entry point launches on the given stream,
// allocates nothing and returns cudaGetLastError() (0 = launched), or -1
// when eps, the shared-memory tile, the phase or the grid is beyond what the
// kernel supports.

#include "stencil_tile3d.cuh"

namespace {

using namespace nlheat;

enum Phase { ALL = 0, INTERIOR = 1, RING = 2 };

constexpr int MAX_BOXES = 6;

// The boxes of one phase, in block coordinates: lower corner, extent, the
// lattice origin of its tiles (the corner rounded down to the lattice, so
// that a warp's z line is one aligned line), tile counts per axis, and the
// first tile (launch block) of each.
struct Boxes {
  int n;
  int lo[MAX_BOXES][3];
  int len[MAX_BOXES][3];
  int org[MAX_BOXES][3];
  int tiles[MAX_BOXES][3];
  int first[MAX_BOXES + 1];
};

// The box and the output origin of this block's tile.
__device__ inline int find_tile(const Boxes& boxes, int tp, int& x0, int& y0, int& z0) {
  int r = 0;
  while (r + 1 < boxes.n && static_cast<int>(blockIdx.x) >= boxes.first[r + 1]) ++r;
  int t = static_cast<int>(blockIdx.x) - boxes.first[r];
  const int tz = t % boxes.tiles[r][2];
  t /= boxes.tiles[r][2];
  const int ty = t % boxes.tiles[r][1];
  const int tx = t / boxes.tiles[r][1];
  x0 = boxes.org[r][0] + tx * tp;
  y0 = boxes.org[r][1] + ty * tp;
  z0 = boxes.org[r][2] + tz * TZ;
  return r;
}

__device__ inline bool in_box(const Boxes& boxes, int r, int x, int y, int z) {
  return x >= boxes.lo[r][0] && x < boxes.lo[r][0] + boxes.len[r][0] && y >= boxes.lo[r][1] &&
         y < boxes.lo[r][1] + boxes.len[r][1] && z >= boxes.lo[r][2] &&
         z < boxes.lo[r][2] + boxes.len[r][2];
}

// -- the register design (stencil_tile3d.cuh), eps 0-6 ----------------------------

template <typename T, typename OpT, int EPS, int TP>
__global__ void __launch_bounds__(TZ * TP)
split_nsum3d_fast(const T* __restrict__ frame, T* __restrict__ out, const Geom3 g,
                  const Span3 span, int chunk, const Boxes boxes) {
  int x0, y0, z0;
  const int r = find_tile(boxes, TP, x0, y0, z0);
  T acc[TP];
  // output (x, y, z) reads frame cells x .. x+2eps (g.shift = eps)
  fast3_sums<T, OpT, EPS, TP>(
      [&](T* win) { fast3_stage<T, EPS, TP>(win, frame, g, span, chunk, x0, y0, z0); }, acc);

  const int x = x0 + threadIdx.y, z = z0 + threadIdx.x;
#pragma unroll
  for (int k = 0; k < TP; ++k) {
    const int y = y0 + k;
    if (in_box(boxes, r, x, y, z))
      out[(static_cast<size_t>(x) * g.out[1] + y) * g.out[2] + z] = acc[k];
  }
}

// -- the shared tile body (stencil_tile3d.cuh), eps above FAST_MAX_EPS3 -----------

template <typename T, typename OpT, int TP>
__global__ void __launch_bounds__(THREADS3)
split_nsum3d_kernel(const T* __restrict__ frame, T* __restrict__ out, const Geom3 g, int eps,
                    const Plan3 plan, const Span3 span, const Boxes boxes) {
  constexpr int KP = points_per_thread<TP>();
  extern __shared__ __align__(16) unsigned char smem_raw[];
  const int wp = TP + 2 * eps, wz = TZ + 2 * eps;
  T* win = reinterpret_cast<T*>(smem_raw);
  T* wbuf = win + wp * wp * wz;
  const int tx = threadIdx.x, ty = threadIdx.y;
  int x0, y0, z0;
  const int r = find_tile(boxes, TP, x0, y0, z0);

  load_window3<T, OpT>(win, wp, wz, frame, g, eps, x0, y0, z0, span);
  __syncthreads();
  T acc[KP];
  window_sums3<T, TP>(win, eps, plan, wbuf, acc);

#pragma unroll
  for (int k = 0; k < KP; ++k) {
    const int p = ty + k * TY3;
    if (p >= TP * TP) continue;
    const int x = x0 + p / TP, y = y0 + p % TP, z = z0 + tx;
    if (in_box(boxes, r, x, y, z))
      out[(static_cast<size_t>(x) * g.out[1] + y) * g.out[2] + z] = acc[k];
  }
}

// The interior on one axis of block length b, tile length t: the lattice
// tiles whose windows lie in the block, else (none fits) [eps, b - eps).
void interior_axis(int b, int eps, int t, int& lo, int& hi) {
  lo = (eps + t - 1) / t * t;
  hi = (b - eps) / t * t;
  if (hi <= lo) {
    lo = eps;
    hi = b - eps;
  }
}

// The boxes of a phase at plane width tp; false when the phase does not
// apply (a degenerate block has no interior or ring) or the grid is too big.
bool phase_boxes(int phase, const int b[3], int eps, int tp, Boxes& B) {
  B = Boxes{};
  auto add = [&](int x, int y, int z, int lx, int ly, int lz) {
    if (lx <= 0 || ly <= 0 || lz <= 0) return;
    const int lo[3] = {x, y, z}, len[3] = {lx, ly, lz};
    for (int d = 0; d < 3; ++d) {
      B.lo[B.n][d] = lo[d];
      B.len[B.n][d] = len[d];
    }
    ++B.n;
  };
  const int e = eps, bx = b[0], by = b[1], bz = b[2];
  const int tlen[3] = {tp, tp, TZ};
  int lo[3], hi[3];
  for (int d = 0; d < 3; ++d) interior_axis(b[d], e, tlen[d], lo[d], hi[d]);
  const int nx = hi[0] - lo[0], ny = hi[1] - lo[1], nz = hi[2] - lo[2];
  const bool degen = bx <= 2 * e || by <= 2 * e || bz <= 2 * e;
  if (phase == ALL) {
    add(0, 0, 0, bx, by, bz);
  } else if (phase == INTERIOR && !degen) {
    add(lo[0], lo[1], lo[2], nx, ny, nz);
  } else if (phase == RING && !degen) {
    add(0, 0, 0, lo[0], by, bz);                      // x-low slab, full face
    add(hi[0], 0, 0, bx - hi[0], by, bz);             // x-high slab
    add(lo[0], 0, 0, nx, lo[1], bz);                  // y-low slab, the box's x rows
    add(lo[0], hi[1], 0, nx, by - hi[1], bz);         // y-high slab
    add(lo[0], lo[1], 0, nx, ny, lo[2]);              // z-low slab, the box's xy core
    add(lo[0], lo[1], hi[2], nx, ny, bz - hi[2]);     // z-high slab
  } else {
    return false;
  }
  long long total = 0;
  for (int i = 0; i < B.n; ++i) {
    B.first[i] = static_cast<int>(total);
    long long n = 1;
    for (int d = 0; d < 3; ++d) {
      B.org[i][d] = B.lo[i][d] / tlen[d] * tlen[d];
      B.tiles[i][d] = (B.lo[i][d] + B.len[i][d] - B.org[i][d] + tlen[d] - 1) / tlen[d];
      n *= B.tiles[i][d];
    }
    total += n;
    if (total > INT_MAX) return false;
  }
  B.first[B.n] = static_cast<int>(total);
  return true;
}

// What a phase's stage may read: the interior the frame's block cells, the
// other phases the whole frame.
Span3 phase_span(int phase, const int b[3], int eps, const Geom3& g) {
  if (phase != INTERIOR) return whole_source(g);
  return {eps, {b[0] + eps, b[1] + eps, b[2] + eps}};
}

template <typename T, typename OpT, int EPS>
int launch_fast(const void* frame, void* out, const int b[3], int phase, cudaStream_t stream) {
  constexpr int TP = fast3_tp<T, EPS>();
  Boxes B;
  if (!phase_boxes(phase, b, EPS, TP, B)) return -1;
  if (B.n == 0) return 0;
  const int sdim[3] = {b[0] + 2 * EPS, b[1] + 2 * EPS, b[2] + 2 * EPS};
  // the window geometry of nsum3d: source = the frame, shift = eps
  const Geom3 geom = interior_geom(b, sdim, EPS, 0, b, TP);
  const Span3 span = phase_span(phase, b, EPS, geom);
  // a window whose z range lies inside the span never meets its z edges, so
  // the interior of the lattice stages as wide a chunk as the frame allows
  int zlo, zhi;
  interior_axis(b[2], EPS, TZ, zlo, zhi);
  const bool lattice_z = phase == INTERIOR && zlo % TZ == 0 && zhi % TZ == 0;
  const int chunk = lattice_z ? fast3_chunk<T, EPS>(geom, frame)
                              : fast3_chunk<T, EPS>(geom, frame, span);
  return fast3_launch_n<T, EPS, TP>(split_nsum3d_fast<T, OpT, EPS, TP>, B.first[B.n], stream,
                                    static_cast<const T*>(frame), static_cast<T*>(out), geom,
                                    span, chunk, B);
}

template <typename T, typename OpT>
int launch(const void* frame, void* out, const int b[3], int eps, int phase, void* stream) {
  const int tp = tile3_width(eps, sizeof(T));
  if (tp == 0) return -1;
  if (b[0] <= 0 || b[1] <= 0 || b[2] <= 0) return 0;
  const auto st = static_cast<cudaStream_t>(stream);
  if (eps <= FAST_MAX_EPS3)
    return with_eps<FAST_MAX_EPS3>(eps, [&](auto e) {
      return launch_fast<T, OpT, decltype(e)::value>(frame, out, b, phase, st);
    });
  Boxes B;
  if (!phase_boxes(phase, b, eps, tp, B)) return -1;
  if (B.n == 0) return 0;
  return with_tp(tp, [&](auto tpc) {
    constexpr int TP = decltype(tpc)::value;
    const int sdim[3] = {b[0] + 2 * eps, b[1] + 2 * eps, b[2] + 2 * eps};
    const Geom3 geom = interior_geom(b, sdim, eps, 0, b, TP);
    auto kernel = split_nsum3d_kernel<T, OpT, TP>;
    const size_t smem = tile3_elems(eps, TP) * sizeof(T);
    const int e = allow_smem(kernel, smem);
    if (e != 0) return e;
    kernel<<<static_cast<unsigned>(B.first[B.n]), dim3(TZ, TY3), smem, st>>>(
        static_cast<const T*>(frame), static_cast<T*>(out), geom, eps, make_plan3(eps),
        phase_span(phase, b, eps, geom), B);
    return static_cast<int>(cudaGetLastError());
  });
}

template <typename T>
int split_typed(int bf16, const void* frame, void* out, int bx, int by, int bz, int eps,
                int phase, void* stream) {
  const int b[3] = {bx, by, bz};
  auto fn = bf16 ? &launch<T, __nv_bfloat16> : &launch<T, T>;
  return fn(frame, out, b, eps, phase, stream);
}

}  // namespace

// dtype: 0 = float32, 1 = float64.  bf16: 1 selects the bfloat16 operand tier.
// phase: 0 = the whole block, 1 = the interior, 2 = the ring.
extern "C" int nlheat_split_nsum3d(int dtype, int bf16, const void* frame, void* out, int bx,
                                   int by, int bz, int eps, int phase, void* stream) {
  if (dtype == 0) return split_typed<float>(bf16, frame, out, bx, by, bz, eps, phase, stream);
  if (dtype == 1) return split_typed<double>(bf16, frame, out, bx, by, bz, eps, phase, stream);
  return -1;
}
