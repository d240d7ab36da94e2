// The neighbour sum of one block of a distributed 3D solve with the halo
// exchange inside the kernel, for NVIDIA Hopper (sm_90a).
//
// Replaces the Pallas TPU kernel of nonlocalheatequation_tpu
//   fused_nsum3d  <- ops/pallas_halo.py:build_fused_nsum_3d (body
//                    _build_rdma_kernel :511): the 3D form of fused_nsum2d
// The input is the block and the blocks around it on the mesh, as device
// pointers: table[((ox+hx)*(2hy+1) + (oy+hy))*(2hz+1) + (oz+hz)] is the
// block at mesh offset (ox, oy, oz), |o| <= h per axis (the exchange plan's
// hop caps, ops/cuda_halo.plan_exchange), null beyond the mesh.  Every
// block is (bx, by, bz), row-major [x][y][z]; the output is the block's sum
// over the masked sphere.  The blocks may sit on one card or on cards this
// one reads by peer access (nlheat_enable_peer in fused_nsum2d.cu); the
// caller orders the launch after the neighbours' last writes and before
// their next ones.
//
// Design, as fused_nsum2d.cu: no halo frame and no band copy.  A tile reads
// its window of the virtual frame from the blocks that hold it (frame cell
// (x, y, z) in [-eps, b+eps) per axis is cell (x mod bx, ...) of the block
// at offset (floor(x/bx), ...); 0 beyond the frame, the mesh or a null
// table entry, the volumetric boundary condition).  One launch covers the
// block's tiles on nsum3d's lattice, so the sum is bitwise nsum3d on the
// halo-exchanged frame.
//
// For 0 <= eps <= FAST_MAX_EPS3 (6) a tile runs nsum3d's register design
// (stencil_tile3d.cuh: fast3_sums; eps a template parameter, a 32 x TP block
// a TP x TP x 32 tile, W_h in registers, one barrier a height), and the
// window load is the exchange (stage_mesh3):
//   * a tile whose window lies in this block (392 of the 1024 tiles of a
//     128^3 f32 block at eps=4) stages it as step3d stages the unpadded
//     state (fast3_stage from the centre block, shift 0);
//   * any other stages cell (a, b, c) of its window from the block that holds
//     it: the window's first line and cell are resolved once an axis (a
//     floor division: block offset and coordinate), every other cell's
//     block stepped from them across the block edges it passes (a compare
//     inside the block, one step beyond it), so no cell divides;
//   * 16 bytes a copy where eps and bz are multiples of a chunk's values
//     (4 in float32, 2 in float64) and every block is 16-byte aligned: then
//     the window's z origin z0 - eps and every block edge in z are
//     multiples of a chunk, so no chunk straddles two blocks or the frame's
//     edge; else 8 bytes where they are multiples of 2 in float32 (eps 2
//     and 6), else (odd eps or bz) one value a copy.  The copies of cells
//     beyond the mesh, a null entry or the frame read nothing and fill
//     zeros.
// The bf16 tier rounds the staged window in place once.  Above eps 6 one
// 8 x 8 x 32 (or narrower) tile a block of 32 x 8 threads runs the shared
// tile body: the window loaded as load_window3 loads it (a tile inside the
// block) or each line's (x, y) block and each lane's two z cells resolved
// once a tile (load_window3_mesh), then window_sums3.
//
// What bounds it on an H100 SXM (NVIDIA's published peaks at the card's
// 700 W limit; computed bounds, not measurements): it reads the block and
// its halo once and writes the block once, about 2 x 8 MiB for a 128^3 f32
// block at eps=4, about 5 us; the sums' 81 adds per point at eps=4 put its
// operations near 2.5 us.
//
// Plain C interface (loaded with ctypes by ops/_build.py and wrapped in
// ops/cuda_halo.py).  The entry point launches on the given stream,
// allocates nothing and returns cudaGetLastError() (0 = launched), or -1
// when eps, the shared-memory tile, the neighbour table or the grid is
// beyond what the kernel supports.

#include "stencil_tile3d.cuh"

#include <cstdint>

namespace {

using namespace nlheat;

// The neighbour table, passed by value: at most 125 blocks (5 x 5 x 5, hops
// up to 2 per axis, or longer on fewer axes).
constexpr int MAX_NB = 125;

struct Neighbours3 {
  const void* p[MAX_NB];
  int h[3];
};

// Frame coordinate g of an axis of block length b -> (block offset o,
// coordinate l in that block), floor division.
__device__ inline void locate(int g, int b, int& o, int& l) {
  if (g >= 0 && g < b) {
    o = 0;
    l = g;
    return;
  }
  o = g >= 0 ? g / b : -((b - 1 - g) / b);
  l = g - o * b;
}

// Whether frame coordinate g (block length b, hop cap h) lies in the frame
// and within the table; sets its block offset and coordinate.
__device__ inline bool resolve(int g, int b, int h, int eps, int& o, int& l) {
  if (g < -eps || g >= b + eps) return false;
  locate(g, b, o, l);
  return o >= -h && o <= h;
}

// Coordinate first + k of an axis of block length b, from first's block
// offset o and coordinate l in it: steps across the block edges (one step
// for a window that reaches one block beyond, none inside the block), so no
// cell divides.
__device__ inline void step_to(int k, int b, int& o, int& l) {
  l += k;
  while (l >= b) {
    l -= b;
    ++o;
  }
}

// -- the register design (stencil_tile3d.cuh), eps 0-6 ----------------------------

// The mesh stage: issue the cp.async copies of the window of the tile at
// (x0, y0, z0), cell (a, b, c) frame cell (x0 - EPS + a, y0 - EPS + b, z0 -
// EPS + c) of this block, read from the block that holds it; 0 beyond the
// frame, the mesh or a null table entry.  The window's first line and cell
// are resolved once (a floor division an axis), every other cell's block
// and coordinates stepped from them.  chunk: the values a copy moves (from
// the host: chunks of it never straddle a block edge or the frame's).
template <typename T, int EPS, int TP>
__device__ __forceinline__ void stage_mesh3(T* win, const Neighbours3& nb, int bx, int by,
                                            int bz, const T* own, int chunk, int x0, int y0,
                                            int z0) {
  using F = Fast3<EPS, TP>;
  const int r0 = x0 - EPS, s0 = y0 - EPS, q0 = z0 - EPS;
  const int ny = 2 * nb.h[1] + 1, nz = 2 * nb.h[2] + 1;
  int ox0, lx0, oy0, ly0, oz0, lz0;
  locate(r0, bx, ox0, lx0);
  locate(s0, by, oy0, ly0);
  locate(q0, bz, oz0, lz0);
  with_chunk<T>(chunk, [&](auto cc) {
    constexpr int C = decltype(cc)::value, PER_LINE = F::WZ / C;
    for (int idx = threadIdx.y * TZ + threadIdx.x; idx < F::LINES * PER_LINE;
         idx += TZ * TP) {
      const int l = idx / PER_LINE, c = (idx - l * PER_LINE) * C;
      const int a = l / F::WP, b = l - a * F::WP;
      int ox = ox0, lx = lx0, oy = oy0, ly = ly0, oz = oz0, lz = lz0;
      step_to(a, bx, ox, lx);
      step_to(b, by, oy, ly);
      step_to(c, bz, oz, lz);
      const int x = r0 + a, y = s0 + b, z = q0 + c;
      const T* blk = nullptr;
      if (x >= -EPS && x < bx + EPS && y >= -EPS && y < by + EPS && z >= -EPS &&
          z < bz + EPS && ox >= -nb.h[0] && ox <= nb.h[0] && oy >= -nb.h[1] &&
          oy <= nb.h[1] && oz >= -nb.h[2] && oz <= nb.h[2])
        blk = static_cast<const T*>(
            nb.p[((ox + nb.h[0]) * ny + oy + nb.h[1]) * nz + oz + nb.h[2]]);
      const T* from =
          blk == nullptr ? own : blk + (static_cast<size_t>(lx) * by + ly) * bz + lz;
      cp_async_chunk<T, C>(win + l * F::WZ + c, from, blk != nullptr);
    }
  });
}

template <typename T, typename OpT, int EPS, int TP>
__global__ void __launch_bounds__(TZ * TP)
fused_nsum3d_fast(T* __restrict__ out, const Geom3 g, int chunk_own, int chunk_mesh,
                  const Neighbours3 nb) {
  int x0, y0, z0;
  tile_origin(g, blockIdx.x, TP, x0, y0, z0);
  const int centre = ((nb.h[0] * (2 * nb.h[1] + 1)) + nb.h[1]) * (2 * nb.h[2] + 1) + nb.h[2];
  const T* own = static_cast<const T*>(nb.p[centre]);
  // output (x, y, z) reads block cells x-eps .. x+eps on each axis
  const bool inside = x0 >= EPS && x0 + TP + EPS <= g.src[0] && y0 >= EPS &&
                      y0 + TP + EPS <= g.src[1] && z0 >= EPS && z0 + TZ + EPS <= g.src[2];
  T acc[TP];
  fast3_sums<T, OpT, EPS, TP>(
      [&](T* win) {
        if (inside)
          fast3_stage<T, EPS, TP>(win, own, g, whole_source(g), chunk_own, x0, y0, z0);
        else
          stage_mesh3<T, EPS, TP>(win, nb, g.src[0], g.src[1], g.src[2], own, chunk_mesh, x0,
                                  y0, z0);
      },
      acc);

  const int x = x0 + threadIdx.y, z = z0 + threadIdx.x;
  if (x >= g.out[0] || z >= g.out[2]) return;
#pragma unroll
  for (int r = 0; r < TP; ++r) {
    const int y = y0 + r;
    if (y < g.out[1]) out[(static_cast<size_t>(x) * g.out[1] + y) * g.out[2] + z] = acc[r];
  }
}

template <typename T, typename OpT, int EPS>
int launch_fast(void* out, const int b[3], const Neighbours3& nb, cudaStream_t stream) {
  constexpr int TP = fast3_tp<T, EPS>();
  // nsum3d's tile lattice over the block; the source is the unpadded block
  // (shift 0), as step3d reads the state
  const Geom3 geom = interior_geom(b, b, 0, 0, b, TP);
  const int count = (2 * nb.h[0] + 1) * (2 * nb.h[1] + 1) * (2 * nb.h[2] + 1);
  const void* own = nb.p[count / 2];
  // the mesh's chunk: the window's z origin z0 - EPS and every block edge in
  // z on its boundaries, every block aligned to it
  int chunk_mesh = vec_width<T>();
  for (; chunk_mesh > 1; chunk_mesh /= 2) {
    bool ok = EPS % chunk_mesh == 0 && b[2] % chunk_mesh == 0;
    for (int i = 0; i < count; ++i)
      ok = ok && reinterpret_cast<uintptr_t>(nb.p[i]) % (chunk_mesh * sizeof(T)) == 0;
    if (ok) break;
  }
  return fast3_launch<T, EPS, TP>(fused_nsum3d_fast<T, OpT, EPS, TP>, geom, stream,
                                  static_cast<T*>(out), geom, fast3_chunk<T, EPS>(geom, own),
                                  chunk_mesh, nb);
}

// -- the shared tile body (stencil_tile3d.cuh), eps above FAST_MAX_EPS3 -----------

// The window of the tile at (x0, y0, z0), each cell read from the block that
// holds it; 0 beyond the frame or the mesh; rounded to the operand type.
// As load_window3: thread row ty takes window lines (a, b), LOAD_LINES at a
// time with every load of a batch issued before the first store, and each
// lane its two z cells, whose blocks it resolves once.
template <typename T, typename OpT>
__device__ void load_window3_mesh(T* win, int wp, int wz, const Neighbours3& nb,
                                  const Geom3& g, int eps, int x0, int y0, int z0) {
  const int bx = g.src[0], by = g.src[1], bz = g.src[2];
  const int ca = threadIdx.x, cb = threadIdx.x + TZ;
  const int nz = 2 * nb.h[2] + 1, ny = 2 * nb.h[1] + 1;
  const int lines = wp * wp;
  int oza = 0, lza = 0, ozb = 0, lzb = 0;
  const bool ina = resolve(z0 - eps + ca, bz, nb.h[2], eps, oza, lza);
  const bool inb = cb < wz && resolve(z0 - eps + cb, bz, nb.h[2], eps, ozb, lzb);
  for (int l0 = threadIdx.y; l0 < lines; l0 += LOAD_LINES * TY3) {
    T va[LOAD_LINES], vb[LOAD_LINES];
#pragma unroll
    for (int k = 0; k < LOAD_LINES; ++k) {
      const int line = l0 + k * TY3;
      const int a = line / wp, b = line - a * wp;
      int ox, lx, oy, ly;
      va[k] = T(0);
      vb[k] = T(0);
      if (line < lines && resolve(x0 - eps + a, bx, nb.h[0], eps, ox, lx) &&
          resolve(y0 - eps + b, by, nb.h[1], eps, oy, ly)) {
        const int base = ((ox + nb.h[0]) * ny + oy + nb.h[1]) * nz + nb.h[2];
        const size_t row = (static_cast<size_t>(lx) * by + ly) * bz;
        const T* pa = ina ? static_cast<const T*>(nb.p[base + oza]) : nullptr;
        const T* pb = inb ? static_cast<const T*>(nb.p[base + ozb]) : nullptr;
        if (pa != nullptr) va[k] = pa[row + lza];
        if (pb != nullptr) vb[k] = pb[row + lzb];
      }
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

template <typename T, typename OpT, int TP>
__global__ void __launch_bounds__(THREADS3)
fused_nsum3d_kernel(T* __restrict__ out, const Geom3 g, int eps, const Plan3 plan,
                    const Neighbours3 nb) {
  constexpr int KP = points_per_thread<TP>();
  extern __shared__ __align__(16) unsigned char smem_raw[];
  const int wp = TP + 2 * eps, wz = TZ + 2 * eps;
  T* win = reinterpret_cast<T*>(smem_raw);
  T* wbuf = win + wp * wp * wz;
  const int tx = threadIdx.x, ty = threadIdx.y;
  int x0, y0, z0;
  tile_origin(g, blockIdx.x, TP, x0, y0, z0);

  // output (x, y, z) reads block cells x-eps .. x+eps on each axis
  if (x0 >= eps && x0 + TP + eps <= g.src[0] && y0 >= eps && y0 + TP + eps <= g.src[1] &&
      z0 >= eps && z0 + TZ + eps <= g.src[2]) {
    const int centre = ((nb.h[0] * (2 * nb.h[1] + 1)) + nb.h[1]) * (2 * nb.h[2] + 1) + nb.h[2];
    load_window3<T, OpT>(win, wp, wz, static_cast<const T*>(nb.p[centre]), g, eps, x0, y0,
                         z0);
  } else {
    load_window3_mesh<T, OpT>(win, wp, wz, nb, g, eps, x0, y0, z0);
  }
  __syncthreads();
  T acc[KP];
  window_sums3<T, TP>(win, eps, plan, wbuf, acc);

#pragma unroll
  for (int k = 0; k < KP; ++k) {
    const int p = ty + k * TY3;
    if (p >= TP * TP) continue;
    const int x = x0 + p / TP, y = y0 + p % TP, z = z0 + tx;
    if (x >= g.out[0] || y >= g.out[1] || z >= g.out[2]) continue;
    out[(static_cast<size_t>(x) * g.out[1] + y) * g.out[2] + z] = acc[k];
  }
}

template <typename T, typename OpT>
int launch(void* out, const int b[3], int eps, const Neighbours3& nb, void* stream) {
  const int tp = tile3_width(eps, sizeof(T));
  if (tp == 0) return -1;
  if (b[0] <= 0 || b[1] <= 0 || b[2] <= 0) return 0;
  if (eps <= FAST_MAX_EPS3)
    return with_eps<FAST_MAX_EPS3>(eps, [&](auto e) {
      return launch_fast<T, OpT, decltype(e)::value>(out, b, nb,
                                                     static_cast<cudaStream_t>(stream));
    });
  return with_tp(tp, [&](auto tpc) {
    constexpr int TP = decltype(tpc)::value;
    // nsum3d's tile lattice over the block; the source is the unpadded block
    // (shift 0), as step3d reads the state
    const Geom3 geom = interior_geom(b, b, 0, 0, b, TP);
    const long long tiles = tile_count(geom);
    if (tiles > INT_MAX) return -1;
    auto kernel = fused_nsum3d_kernel<T, OpT, TP>;
    const size_t smem = tile3_elems(eps, TP) * sizeof(T);
    const int e = allow_smem(kernel, smem);
    if (e != 0) return e;
    kernel<<<static_cast<unsigned>(tiles), dim3(TZ, TY3), smem,
             static_cast<cudaStream_t>(stream)>>>(static_cast<T*>(out), geom, eps,
                                                  make_plan3(eps), nb);
    return static_cast<int>(cudaGetLastError());
  });
}

}  // namespace

// dtype: 0 = float32, 1 = float64.  bf16: 1 selects the bfloat16 operand tier.
// table: (2hx+1)*(2hy+1)*(2hz+1) block pointers (see the top of this file),
// the centre entry this block's.
extern "C" int nlheat_fused_nsum3d(int dtype, int bf16, const void* const* table, int hx,
                                   int hy, int hz, void* out, int bx, int by, int bz, int eps,
                                   void* stream) {
  if (hx < 0 || hy < 0 || hz < 0) return -1;
  const int count = (2 * hx + 1) * (2 * hy + 1) * (2 * hz + 1);
  if (count > MAX_NB) return -1;
  Neighbours3 nb{};
  for (int i = 0; i < count; ++i) nb.p[i] = table[i];
  nb.h[0] = hx;
  nb.h[1] = hy;
  nb.h[2] = hz;
  if (nb.p[count / 2] == nullptr) return -1;  // the centre: this block
  const int b[3] = {bx, by, bz};
  if (dtype == 0)
    return (bf16 ? &launch<float, __nv_bfloat16> : &launch<float, float>)(out, b, eps, nb,
                                                                          stream);
  if (dtype == 1)
    return (bf16 ? &launch<double, __nv_bfloat16> : &launch<double, double>)(out, b, eps, nb,
                                                                             stream);
  return -1;
}
