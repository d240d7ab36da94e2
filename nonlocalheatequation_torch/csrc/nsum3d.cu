// Masked-sphere neighbour sum and fused forward-Euler step for the 3D
// nonlocal heat operator, for NVIDIA Hopper (sm_90a).
//
// Replaces the Pallas TPU kernel of nonlocalheatequation_tpu
//   nsum3d  <- ops/pallas_kernel.py:build_neighbor_sum_3d (body
//              _block_neighbor_sum_3d :672): the method="pallas" branch of
//              NonlocalOp3D.neighbor_sum_padded
// and fuses it, in step3d, with the Euler epilogue that XLA fuses outside
// the TPU kernel (the generic step, ops/nonlocal_op.py:519-530):
//   production  u + dt*(scale*(nsum - wsum*u))
//   test form   u + dt*((scale*(nsum - wsum*u)) + (coef_g*G + coef_lg*L(G)))
//
// What bounds them on an H100 SXM (NVIDIA's published peaks at the card's
// 700 W limit: 3.35 TB/s HBM3, 67 TFLOP/s f32 outside the tensor cores;
// computed bounds, not measurements): at 256^3, eps=4, f32 the step reads u
// once and writes the next state once, 2 x 64 MiB, about 40 us.  The direct
// sum is 256 adds per point, 4.3 G adds per step, about 64 us at the f32
// peak, above the byte bound; the z window sums cut that to 49 column adds
// plus about 23 window-sum adds per point at the 8 x 8 x 32 tile.  Inside
// the SM the shared-memory traffic binds first: about 127 accesses per
// point in the tile body (stencil_tile3d.cuh), with which step3d took
// 0.5047 ms, 12.6x the byte bound (H100 80GB HBM3 at 700 W, PERF.md).
//
// The order of the adds (the contract shared with stencil_tile3d.cuh, whose
// body carried3d, resident3d, split_nsum3d and fused_nsum3d run, and with
// the plain versions' sphere_sum, ops/cuda_kernel.py):
//   1. every window line's z sums W_0 = line[0], W_h = (W_{h-1} + line[-h])
//      + line[+h], one pair of cells per height h;
//   2. each output starts from 0 and adds W_{h(i,j)} of the window line at
//      plane offset (i, j) over the sphere's columns, heights ascending, then
//      (i, j) ascending within a height;
//   3. the epilogue u + dt*(scale*(nsum - wsum*u) [+ (cg*G + clg*L(G))]), every
//      multiply and add rounded on its own (stencil_tile.cuh).
//
// Design, for 0 <= eps <= FAST_MAX_EPS3 (6): a register design.  A block of
// 32 x TP threads owns a TP x TP x 32 output tile (TP = 8 in float32; in
// float64 8 up to eps=4, then 4) and stages its (TP+2eps)^2 x (32+2eps)
// window by cp.async, the cells outside the source zero-filled by the copy
// itself: 16 bytes a copy where the source's rows and the window's z
// origin fall on 16-byte boundaries (nz a multiple of 4 at even eps in
// float32, as the 256^3 eps=4 step), else one cell a copy.  Thread (z lane,
// row x) owns the window rows x + TP*m, every line of them, and the TP
// outputs (x, 0 .. TP-1) of its lane.  It advances W_h of its lines in
// registers (two window reads a height, only for the lines a column of that
// height or above can reach) and writes W_h to one of two W buffers in
// shared memory, by the parity of h, so one barrier a height separates the
// writers from the readers.  Each output row then reads W_h of window row
// x + i into registers once and adds it over every column (i, j) of height
// h and every output of the row: about 29 W reads a point at eps=4 against
// 49 adds.  eps is a template parameter, so every offset is a constant and
// every register index fixed.  Shared-memory accesses per point at eps=4,
// f32: about 5 (staging) + 23 (window reads) + 13 (W writes) + 29 (W
// reads), 70 in all, against the tile body's 127.  Up to eps=4 in float32
// two blocks share an SM (104 KB each), so one block's load overlaps the
// other's sums; the second W buffer takes the room a second, prefetched
// window would need.  In the bf16 tier the block rounds its staged window
// in place once.
//
// eps 7-12 run the shared tile body (stencil_tile3d.cuh), which gives the
// same bits.  Types: state float or double, operand the state type or
// __nv_bfloat16.  The step reads the UNPADDED state (zeros outside the
// domain, the volumetric boundary condition), so no padded copy of the
// state is made per step.

// Plain C interface (loaded with ctypes by ops/_build.py and wrapped in
// ops/cuda_kernel3d.py).  Each entry point launches on the given stream,
// allocates nothing and returns cudaGetLastError() (0 = launched), or -1
// when eps, the shared-memory tile or the grid is beyond what the kernel
// supports.  These limits live here only; the wrapper turns -1 into a
// ValueError.

#include "stencil_tile3d.cuh"

#include <cstdint>

namespace {

using namespace nlheat;

enum Mode { NSUM = 0, STEP = 1, STEP_TEST = 2 };

// -- the register design, 0 <= eps <= FAST_MAX_EPS3 ----------------------------------

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
// (tp+2eps)^2 lines of 32+2eps, and two W buffers of (tp+2eps)^2 lines of 32.
__host__ __device__ constexpr size_t fast3_elems(int eps, int tp) {
  return static_cast<size_t>(tp + 2 * eps) * (tp + 2 * eps) * (TZ + 2 * eps + 2 * TZ);
}

// The plane width: the widest of 8, 4, 2, 1 whose tile fits a block's shared
// memory, or 0.
template <typename T, int EPS>
__host__ __device__ constexpr int fast3_tp() {
  for (int tp = 8; tp >= 1; tp /= 2)
    if (fast3_elems(EPS, tp) * sizeof(T) <= FAST3_FULL) return tp;
  return 0;
}

template <int EPS, int TP>
struct Fast3 {
  static constexpr int WP = TP + 2 * EPS;               // window lines a side
  static constexpr int WZ = TZ + 2 * EPS;               // cells a window line
  static constexpr int LINES = WP * WP;
  static constexpr int NR = (WP + TP - 1) / TP;         // window rows a thread owns
  static_assert(NR * WP <= 64, "the W registers of a thread");
};

// Heights H .. EPS of the sums (steps 1 and 2 of the order in the header).
// Thread (z lane tx, row ty) owns window rows ty + TP*m, every line (a, b)
// of them, and the outputs (ty, 0 .. TP-1) of its lane.  It grows W_H of its
// lines in registers, for the lines within reach of a column of height >= H,
// and writes them to the W buffer of H's parity when a column has height H;
// after one barrier each output adds W_H over those columns, (i, j)
// ascending: row i's W values are read into registers once and serve every
// j and every output of the row.  The line b of a row is a constant, so
// every offset is.
template <typename T, int EPS, int TP, int H>
__device__ __forceinline__ void sums3_from(const T* win, T* wbuf,
                                           T (&W)[Fast3<EPS, TP>::NR * Fast3<EPS, TP>::WP],
                                           T (&acc)[TP]) {
  using F = Fast3<EPS, TP>;
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
  if constexpr (H < EPS) sums3_from<T, EPS, TP, H + 1>(win, wbuf, W, acc);
}

// values a 16-byte copy moves
template <typename T>
__host__ __device__ constexpr int vec_width() { return 16 / static_cast<int>(sizeof(T)); }

template <typename T, typename OpT, int EPS, int TP>
__global__ void __launch_bounds__(TZ * TP)
nlheat3d_fast(const T* __restrict__ src, T* __restrict__ out, const Geom3 g, bool vec, int mode,
              const T* __restrict__ gsrc, const T* __restrict__ lgsrc, T scale, T wsum, T dt,
              T coef_g, T coef_lg) {
  using F = Fast3<EPS, TP>;
  extern __shared__ __align__(16) unsigned char smem_raw[];
  T* win = reinterpret_cast<T*>(smem_raw);
  T* wbuf = win + F::LINES * F::WZ;
  const int tx = threadIdx.x, ty = threadIdx.y;
  int x0, y0, z0;
  tile_origin(g, blockIdx.x, TP, x0, y0, z0);

  // the window: cell (a, b, c) is src[x0 - EPS + shift + a][...][...], 0
  // outside the source; consecutive threads stage consecutive cells, in
  // 16-byte chunks where every chunk lies wholly inside or outside the
  // source and is aligned (vec, from the host), else one at a time
  const int r0 = x0 - EPS + g.shift, s0 = y0 - EPS + g.shift, q0 = z0 - EPS + g.shift;
  auto stage = [&](auto chunk) {  // chunk: values a copy moves, 1 or vec_width<T>()
    constexpr int C = decltype(chunk)::value, PER_LINE = F::WZ / C;
    for (int idx = ty * TZ + tx; idx < F::LINES * PER_LINE; idx += TZ * TP) {
      const int l = idx / PER_LINE, c = (idx - l * PER_LINE) * C;
      const int a = l / F::WP, b = l - a * F::WP;
      const int r = r0 + a, s = s0 + b, q = q0 + c;
      const bool ok =
          r >= 0 && r < g.src[0] && s >= 0 && s < g.src[1] && q >= 0 && q < g.src[2];
      const T* from = ok ? src + (static_cast<size_t>(r) * g.src[1] + s) * g.src[2] + q : src;
      if constexpr (C == 1)
        cp_async_value(win + l * F::WZ + c, from, ok);
      else
        cp_async_16(win + l * F::WZ + c, from, ok);
    }
  };
  if (vec)
    stage(std::integral_constant<int, vec_width<T>()>{});
  else
    stage(std::integral_constant<int, 1>{});
  cp_async_commit();
  cp_async_wait<0>();
  __syncthreads();
  if constexpr (!std::is_same<T, OpT>::value) {
    for (int idx = ty * TZ + tx; idx < F::LINES * F::WZ; idx += TZ * TP)
      win[idx] = Operand<T, OpT>::round(win[idx]);
    __syncthreads();
  }

  T W[F::NR * F::WP];
  T acc[TP];
#pragma unroll
  for (int r = 0; r < TP; ++r) acc[r] = T(0);
  sums3_from<T, EPS, TP, 0>(win, wbuf, W, acc);

  // step 3
  const int x = x0 + ty, z = z0 + tx;
  if (x >= g.out[0] || z >= g.out[2]) return;
#pragma unroll
  for (int r = 0; r < TP; ++r) {
    const int y = y0 + r;
    if (y >= g.out[1]) continue;
    const size_t o = (static_cast<size_t>(x) * g.out[1] + y) * g.out[2] + z;
    if (mode == NSUM) {
      out[o] = acc[r];
    } else {
      const T center = win[((ty + EPS) * F::WP + r + EPS) * F::WZ + tx + EPS];
      T du = operator_du(acc[r], center, scale, wsum);
      if (mode == STEP_TEST)
        du = add_rn(du, add_rn(mul_rn(coef_g, gsrc[o]), mul_rn(coef_lg, lgsrc[o])));
      const T carry = std::is_same<T, OpT>::value ? center : src[o];
      out[o] = euler(carry, dt, du);
    }
  }
}

template <typename T, typename OpT, int EPS>
int launch_fast(const void* src, const int sdim[3], int shift, void* out, const int n[3],
                int mode, const void* g, const void* lg, double scale, double wsum, double dt,
                double coef_g, double coef_lg, cudaStream_t stream) {
  constexpr int TP = fast3_tp<T, EPS>();
  static_assert(TP > 0, "every eps of the register design fits a block");
  const size_t smem = fast3_elems(EPS, TP) * sizeof(T);
  if (smem > static_cast<size_t>(smem_limit())) return -1;
  const Geom3 geom = interior_geom(n, sdim, shift, 0, n, TP);
  const long long tiles = tile_count(geom);
  if (tiles > INT_MAX) return -1;
  // 16-byte staging: the window's lines and z origins (z0 - EPS + shift, z0
  // a multiple of 32) and the source's rows on 16-byte boundaries, so that
  // no chunk straddles the source's z edges
  constexpr int V = vec_width<T>();
  const bool vec = (TZ + 2 * EPS) % V == 0 && (shift - EPS) % V == 0 && sdim[2] % V == 0 &&
                   reinterpret_cast<uintptr_t>(src) % 16 == 0;
  auto kernel = nlheat3d_fast<T, OpT, EPS, TP>;
  const int e = allow_smem(kernel, smem);
  if (e != 0) return e;
  kernel<<<static_cast<unsigned>(tiles), dim3(TZ, TP), smem, stream>>>(
      static_cast<const T*>(src), static_cast<T*>(out), geom, vec, mode, static_cast<const T*>(g),
      static_cast<const T*>(lg), static_cast<T>(scale), static_cast<T>(wsum),
      static_cast<T>(dt), static_cast<T>(coef_g), static_cast<T>(coef_lg));
  return static_cast<int>(cudaGetLastError());
}

// Instantiate launch_fast for eps 0..FAST_MAX_EPS3 by a compile-time switch.
template <typename T, typename OpT, int EPS = 0>
int dispatch_fast(int eps, const void* src, const int sdim[3], int shift, void* out,
                  const int n[3], int mode, const void* g, const void* lg, double scale,
                  double wsum, double dt, double coef_g, double coef_lg, cudaStream_t stream) {
  if (eps == EPS)
    return launch_fast<T, OpT, EPS>(src, sdim, shift, out, n, mode, g, lg, scale, wsum, dt,
                                    coef_g, coef_lg, stream);
  if constexpr (EPS < FAST_MAX_EPS3)
    return dispatch_fast<T, OpT, EPS + 1>(eps, src, sdim, shift, out, n, mode, g, lg, scale,
                                          wsum, dt, coef_g, coef_lg, stream);
  return -1;
}

// -- the shared tile body (stencil_tile3d.cuh), eps above FAST_MAX_EPS3 -----------

template <typename T, typename OpT, int TP>
__global__ void __launch_bounds__(THREADS3)
nlheat3d_kernel(const T* __restrict__ src, T* __restrict__ out, const Geom3 g, int eps,
                int mode, const Plan3 plan, const T* __restrict__ gsrc,
                const T* __restrict__ lgsrc, T scale, T wsum, T dt, T coef_g, T coef_lg) {
  constexpr int KP = points_per_thread<TP>();
  extern __shared__ __align__(16) unsigned char smem_raw[];
  const int wp = TP + 2 * eps, wz = TZ + 2 * eps;
  T* win = reinterpret_cast<T*>(smem_raw);
  T* wbuf = win + wp * wp * wz;
  const int tx = threadIdx.x, ty = threadIdx.y;
  int x0, y0, z0;
  tile_origin(g, blockIdx.x, TP, x0, y0, z0);

  load_window3<T, OpT>(win, wp, wz, src, g, eps, x0, y0, z0);
  __syncthreads();
  T acc[KP];
  window_sums3<T, TP>(win, eps, plan, wbuf, acc);

#pragma unroll
  for (int k = 0; k < KP; ++k) {
    const int p = ty + k * TY3;
    if (p >= TP * TP) continue;
    const int xl = p / TP, yl = p % TP;
    const int x = x0 + xl, y = y0 + yl, z = z0 + tx;
    if (x >= g.out[0] || y >= g.out[1] || z >= g.out[2]) continue;
    const size_t o = (static_cast<size_t>(x) * g.out[1] + y) * g.out[2] + z;
    if (mode == NSUM) {
      out[o] = acc[k];
    } else {
      const T center = win[((xl + eps) * wp + yl + eps) * wz + tx + eps];
      T du = operator_du(acc[k], center, scale, wsum);
      if (mode == STEP_TEST)
        du = add_rn(du, add_rn(mul_rn(coef_g, gsrc[o]), mul_rn(coef_lg, lgsrc[o])));
      const T carry = std::is_same<T, OpT>::value ? center : src[o];
      out[o] = euler(carry, dt, du);
    }
  }
}

template <typename T, typename OpT>
int launch(const void* src, const int sdim[3], int shift, void* out, const int n[3], int eps,
           int mode, const void* g, const void* lg, double scale, double wsum, double dt,
           double coef_g, double coef_lg, void* stream) {
  const int tp = tile3_width(eps, sizeof(T));
  if (tp == 0) return -1;
  if (n[0] <= 0 || n[1] <= 0 || n[2] <= 0) return 0;
  if (eps <= FAST_MAX_EPS3)
    return dispatch_fast<T, OpT>(eps, src, sdim, shift, out, n, mode, g, lg, scale, wsum, dt,
                                 coef_g, coef_lg, static_cast<cudaStream_t>(stream));
  return with_tp(tp, [&](auto tpc) {
    constexpr int TP = decltype(tpc)::value;
    const Geom3 geom = interior_geom(n, sdim, shift, 0, n, TP);
    const long long tiles = tile_count(geom);
    if (tiles > INT_MAX) return -1;
    auto kernel = nlheat3d_kernel<T, OpT, TP>;
    const size_t smem = tile3_elems(eps, TP) * sizeof(T);
    const int e = allow_smem(kernel, smem);
    if (e != 0) return e;
    kernel<<<static_cast<unsigned>(tiles), dim3(TZ, TY3), smem,
             static_cast<cudaStream_t>(stream)>>>(
        static_cast<const T*>(src), static_cast<T*>(out), geom, eps, mode, make_plan3(eps),
        static_cast<const T*>(g), static_cast<const T*>(lg), static_cast<T>(scale),
        static_cast<T>(wsum), static_cast<T>(dt), static_cast<T>(coef_g),
        static_cast<T>(coef_lg));
    return static_cast<int>(cudaGetLastError());
  });
}

template <typename T>
int nsum_typed(int bf16, const void* upad, void* out, int nx, int ny, int nz, int eps,
               void* stream) {
  const int n[3] = {nx, ny, nz};
  const int sdim[3] = {nx + 2 * eps, ny + 2 * eps, nz + 2 * eps};
  auto fn = bf16 ? &launch<T, __nv_bfloat16> : &launch<T, T>;
  return fn(upad, sdim, eps, out, n, eps, NSUM, nullptr, nullptr, 0.0, 0.0, 0.0, 0.0, 0.0,
            stream);
}

template <typename T>
int step_typed(int bf16, const void* u, void* out, const void* g, const void* lg, int nx,
               int ny, int nz, int eps, double scale, double wsum, double dt, double cg,
               double clg, void* stream) {
  const int n[3] = {nx, ny, nz};
  auto fn = bf16 ? &launch<T, __nv_bfloat16> : &launch<T, T>;
  return fn(u, n, 0, out, n, eps, g != nullptr ? STEP_TEST : STEP, g, lg, scale, wsum, dt, cg,
            clg, stream);
}

}  // namespace

// dtype: 0 = float32, 1 = float64.  bf16: 1 selects the bfloat16 operand tier.
// upad is the (nx+2eps, ny+2eps, nz+2eps) halo-padded block, out (nx, ny, nz).
extern "C" int nlheat_nsum3d(int dtype, int bf16, const void* upad, void* out, int nx, int ny,
                             int nz, int eps, void* stream) {
  if (dtype == 0) return nsum_typed<float>(bf16, upad, out, nx, ny, nz, eps, stream);
  if (dtype == 1) return nsum_typed<double>(bf16, upad, out, nx, ny, nz, eps, stream);
  return -1;
}

// g == nullptr selects the production form; otherwise g and lg are the
// (nx, ny, nz) manufactured-source profiles and du gains
// coef_g*G + coef_lg*L(G), coef_g = -2*pi*sin(2*pi*t*dt),
// coef_lg = -cos(2*pi*t*dt) (from the host).
extern "C" int nlheat_step3d(int dtype, int bf16, const void* u, void* out, const void* g,
                             const void* lg, int nx, int ny, int nz, int eps, double scale,
                             double wsum, double dt, double coef_g, double coef_lg,
                             void* stream) {
  if (dtype == 0)
    return step_typed<float>(bf16, u, out, g, lg, nx, ny, nz, eps, scale, wsum, dt, coef_g,
                             coef_lg, stream);
  if (dtype == 1)
    return step_typed<double>(bf16, u, out, g, lg, nx, ny, nz, eps, scale, wsum, dt, coef_g,
                              coef_lg, stream);
  return -1;
}

// The plane width of the 3D tile body's tiles for this dtype and eps (8, 4,
// 2 or 1; the register design below eps 7 sizes its own), or 0 when the
// kernels refuse eps.
extern "C" int nlheat_tile3d(int dtype, int eps) {
  if (dtype == 0) return tile3_width(eps, sizeof(float));
  if (dtype == 1) return tile3_width(eps, sizeof(double));
  return 0;
}
