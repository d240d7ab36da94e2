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
//   INTERIOR  the box [eps, b-eps) on every axis (no halo read);
//   RING      the six eps-wide face slabs, as _nsum_phases_3d splits them: x
//             slabs full face, y slabs on the middle x rows, z slabs on the
//             middle xy core;
//   ALL       the whole block in one pass (a side <= 2eps: no interior).
//
// What bounds it on an H100 SXM (NVIDIA's published peaks at the card's
// 700 W limit; computed bounds, not measurements): the function reads the
// frame once and writes the block once, about 2 x 8 MiB for a 128^3 f32
// block at eps=4, about 5 us; the tile body's 81 adds per point at eps=4
// put its operations near 2.5 us, so bytes bound it, and the tile body's
// shared-memory work sets its time (as nsum3d's).
//
// Design.  Each phase is a list of up to six boxes of the output; one
// launch covers every TP x TP x 32 tile of each box (a 1D grid, the box
// found from the block index; the tiles' z lines aligned to the block's
// 32-cell lattice, as nsum3d's are), and a tile writes only its cells
// inside its box.  A tile runs the tile body of nsum3d (stencil_tile3d.cuh):
// its window staged in shared memory, each output summed in the order fixed
// by the stencil plan, which depends neither on where the tile sits nor on
// its width.  So INTERIOR then RING (or ALL) gives exactly the bits of nsum3d on
// the same frame.  The z slabs' tiles are 32 cells deep across an eps-deep
// slab, so the ring computes more cells than it keeps.  Types: float or
// double, operand the state type or __nv_bfloat16.
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
// lattice origin of its tiles (the corner, with z rounded down to a
// multiple of TZ so that a warp's z line is one aligned line), tile counts
// per axis, and the first tile (launch block) of each.
struct Boxes {
  int n;
  int lo[MAX_BOXES][3];
  int len[MAX_BOXES][3];
  int org[MAX_BOXES][3];
  int tiles[MAX_BOXES][3];
  int first[MAX_BOXES + 1];
};

template <typename T, typename OpT, int TP>
__global__ void __launch_bounds__(THREADS3)
split_nsum3d_kernel(const T* __restrict__ frame, T* __restrict__ out, const Geom3 g, int eps,
                    const Plan3 plan, const Boxes boxes) {
  constexpr int KP = points_per_thread<TP>();
  extern __shared__ __align__(16) unsigned char smem_raw[];
  const int wp = TP + 2 * eps, wz = TZ + 2 * eps;
  T* win = reinterpret_cast<T*>(smem_raw);
  T* wbuf = win + wp * wp * wz;
  const int tx = threadIdx.x, ty = threadIdx.y;
  int r = 0;
  while (r + 1 < boxes.n && static_cast<int>(blockIdx.x) >= boxes.first[r + 1]) ++r;
  int t = static_cast<int>(blockIdx.x) - boxes.first[r];
  const int tz = t % boxes.tiles[r][2];
  t /= boxes.tiles[r][2];
  const int tyy = t % boxes.tiles[r][1];
  const int txx = t / boxes.tiles[r][1];
  const int x0 = boxes.org[r][0] + txx * TP;
  const int y0 = boxes.org[r][1] + tyy * TP;
  const int z0 = boxes.org[r][2] + tz * TZ;

  // output (x, y, z) reads frame cells x .. x+2eps (g.shift = eps)
  load_window3<T, OpT>(win, wp, wz, frame, g, eps, x0, y0, z0);
  __syncthreads();
  T acc[KP];
  window_sums3<T, TP>(win, eps, plan, wbuf, acc);

#pragma unroll
  for (int k = 0; k < KP; ++k) {
    const int p = ty + k * TY3;
    if (p >= TP * TP) continue;
    const int x = x0 + p / TP, y = y0 + p % TP, z = z0 + tx;
    if (x >= boxes.lo[r][0] + boxes.len[r][0] || y >= boxes.lo[r][1] + boxes.len[r][1] ||
        z < boxes.lo[r][2] || z >= boxes.lo[r][2] + boxes.len[r][2])
      continue;
    out[(static_cast<size_t>(x) * g.out[1] + y) * g.out[2] + z] = acc[k];
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
  const bool degen = bx <= 2 * e || by <= 2 * e || bz <= 2 * e;
  if (phase == ALL) {
    add(0, 0, 0, bx, by, bz);
  } else if (phase == INTERIOR && !degen) {
    add(e, e, e, bx - 2 * e, by - 2 * e, bz - 2 * e);
  } else if (phase == RING && !degen) {
    add(0, 0, 0, e, by, bz);                          // x-low slab, full face
    add(bx - e, 0, 0, e, by, bz);                     // x-high slab
    add(e, 0, 0, bx - 2 * e, e, bz);                  // y-low slab, middle x rows
    add(e, by - e, 0, bx - 2 * e, e, bz);             // y-high slab
    add(e, e, 0, bx - 2 * e, by - 2 * e, e);          // z-low slab, middle xy core
    add(e, e, bz - e, bx - 2 * e, by - 2 * e, e);     // z-high slab
  } else {
    return false;
  }
  long long total = 0;
  const int tlen[3] = {tp, tp, TZ};
  for (int i = 0; i < B.n; ++i) {
    B.first[i] = static_cast<int>(total);
    long long n = 1;
    for (int d = 0; d < 3; ++d) {
      B.org[i][d] = d == 2 ? B.lo[i][d] / TZ * TZ : B.lo[i][d];
      B.tiles[i][d] = (B.lo[i][d] + B.len[i][d] - B.org[i][d] + tlen[d] - 1) / tlen[d];
      n *= B.tiles[i][d];
    }
    total += n;
    if (total > INT_MAX) return false;
  }
  B.first[B.n] = static_cast<int>(total);
  return true;
}

template <typename T, typename OpT>
int launch(const void* frame, void* out, const int b[3], int eps, int phase, void* stream) {
  const int tp = tile3_width(eps, sizeof(T));
  if (tp == 0) return -1;
  if (b[0] <= 0 || b[1] <= 0 || b[2] <= 0) return 0;
  Boxes B;
  if (!phase_boxes(phase, b, eps, tp, B)) return -1;
  if (B.n == 0) return 0;
  return with_tp(tp, [&](auto tpc) {
    constexpr int TP = decltype(tpc)::value;
    const int sdim[3] = {b[0] + 2 * eps, b[1] + 2 * eps, b[2] + 2 * eps};
    // the window geometry of nsum3d: source = the frame, shift = eps
    const Geom3 geom = interior_geom(b, sdim, eps, 0, b, TP);
    auto kernel = split_nsum3d_kernel<T, OpT, TP>;
    const size_t smem = tile3_elems(eps, TP) * sizeof(T);
    const int e = allow_smem(kernel, smem);
    if (e != 0) return e;
    kernel<<<static_cast<unsigned>(B.first[B.n]), dim3(TZ, TY3), smem,
             static_cast<cudaStream_t>(stream)>>>(static_cast<const T*>(frame),
                                                  static_cast<T*>(out), geom, eps,
                                                  make_plan3(eps), B);
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
