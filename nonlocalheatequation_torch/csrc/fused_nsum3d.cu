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
// at offset (floor(x/bx), ...); 0 beyond the mesh).  A tile whose window
// lies in this block loads it as step3d loads the unpadded state; the
// others resolve each line's (x, y) block once and each lane's two z cells
// once per tile, with load_window3's batching of loads.  One launch covers
// the block's TP x TP x 32 tiles on nsum3d's lattice and runs nsum3d's tile
// body (stencil_tile3d.cuh), so the sum is bitwise nsum3d on the
// halo-exchanged frame.
//
// What bounds it on an H100 SXM (NVIDIA's published peaks at the card's
// 700 W limit; computed bounds, not measurements): it reads the block and
// its halo once and writes the block once, about 2 x 8 MiB for a 128^3 f32
// block at eps=4, about 5 us; the tile body's 81 adds per point at eps=4
// put its operations near 2.5 us.
//
// Plain C interface (loaded with ctypes by ops/_build.py and wrapped in
// ops/cuda_halo.py).  The entry point launches on the given stream,
// allocates nothing and returns cudaGetLastError() (0 = launched), or -1
// when eps, the shared-memory tile, the neighbour table or the grid is
// beyond what the kernel supports.

#include "stencil_tile3d.cuh"

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
