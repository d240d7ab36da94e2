// K forward-Euler steps per launch by trapezoidal temporal blocking, for
// NVIDIA Hopper (sm_90a).
//
// Replaces the Pallas TPU kernel
//   superstep2d <- nonlocalheatequation_tpu/ops/pallas_kernel.py:_build_superstep_kernel
//                  (make_superstep_multi_step_fn)
//
// Each block owns an OT x OT output tile (OT = 64 or 32) of the unpadded
// (nx, ny) state.  It stages the window widened by K*eps on every side,
// S = OT + 2K*eps, in shared memory, then advances it K levels there: level
// j computes the band of side OT + 2(K-j)*eps centred on the tile from level
// j-1's band (the window for j = 1).  Every level's band is masked to the
// domain (0 outside), which is the volumetric boundary condition re-applied
// every level, so a level's values are exactly what the per-step kernel
// gives after j steps.  Only level K, the output tile, is written to device
// memory.
//
// The order of the adds is the contract shared with stencil_tile.cuh and
// batched_step2d.cu: each window row's W_0 = row[0], W_h = (W_{h-1} +
// row[-h]) + row[+h]; each output adds W_{h_i} of its x offsets i from 0,
// heights ascending, then i ascending; the epilogue rounds every multiply
// and add on its own.  So K levels are bit-identical to K step2d launches
// and to superstep2d_plain (ops/cuda_kernel.py, which sums in disc_sum's
// order).
//
// Design, for 0 <= eps <= FAST_MAX_EPS (8): the register design of
// batched_step2d.cu (stencil_tile.cuh, register_sums).  A block of four
// warps (six where just two blocks share an SM) stages its window by
// cp.async, the cells outside the domain zero-filled by the copy itself.
// Each level's band is cut into items of 32 columns by RUN rows (RUN = 32
// in float32, 16 in float64; the last item of a row or column shifted back
// to end at the band's edge, its overlap not written twice), dealt over the
// warps.  A thread owns one column of an item: it keeps W_h of the RUN +
// 2eps window rows it needs in registers, reading the level buffer in
// shared memory (two reads a height a row), and adds each height's x
// offsets from those registers.  No barrier falls inside a level; one
// separates the levels.  Where two or more blocks share an SM (OT = 64 in
// float32 up to eps=8 at K=3), one block's load overlaps another's levels.
//
// Redundant work: the levels compute the items' points, sum_j
// ceil(band_j/32) * ceil(band_j/RUN) * 32*RUN, for K*OT^2 of output; at
// eps=8, f32, OT=64 that is 1.63x at K=2 and 1.83x at K=3 (the band of
// level j rounded up to whole items; the tile body's 32 x 32 sub-tiles give
// the same counts).  Shared memory per point and level: (RUN + 2eps)(2eps +
// 1)/RUN reads for the column sums (25.5 at eps=8, f32), one centre read
// and one write, against about 2(2eps+1) + (2eps+1)(32+2eps)/32 + 2 a point
// and 2(eps+1) barriers a sub-tile in the tile body.
//
// eps 9-64 run the shared tile body (stencil_tile.cuh window_sums, 32 x 32
// sub-tiles one after another, two barriers a height), which gives the same
// bits.  The register design stops at eps=8 to keep the build short: each
// eps is four fully unrolled instantiations (two types, two tiers).
//
// bf16 tier: the state buffers stay in full precision.  The register design
// rounds every cell it reads for the sums and the operator's centre to
// bfloat16 (stencil_tile.cuh Operand), while the carry reads the unrounded
// state; the tile body rounds the band it reads into a third buffer first.
// Either way each level rounds only its operator's operand, as the per-step
// bf16 tier does.
//
// What bounds it on an H100 SXM (published peaks, computed, not measured):
// one state read and one written per launch, so K steps move the bytes of
// one (about 40 us at 4096^2, eps=8, f32); the operations are K times the
// step's (about 10 us each) plus the redundant bands.  Inside the SM the
// shared-memory reads above bind first.
//
// Plain C interface (ops/_build.py, ops/cuda_kernel.py): launches on the
// given stream, allocates nothing, returns cudaGetLastError() or -1 when K,
// eps, the shared memory or the grid is beyond the kernel's limits.
// nlheat_superstep2d_fits is the fit gate: the output tile side, or 0.

#include "stencil_tile.cuh"

namespace {

using namespace nlheat;

constexpr int MAX_K = 4;
constexpr int FAST_MAX_EPS = 8;   // the register design's largest eps

template <typename T>
__host__ __device__ constexpr int fast_run() { return sizeof(T) == 4 ? 32 : 16; }  // item rows

// Shared memory of a launch: the register design's two S x S state buffers,
// or the tile body's two (three in the bf16 tier) and its sum buffer.
template <typename T>
size_t superstep_smem(int ot, int eps, int ksteps, bool bf16) {
  const size_t s = ot + 2 * ksteps * eps;
  if (eps <= FAST_MAX_EPS) return 2 * s * s * sizeof(T);
  return ((bf16 ? 3 : 2) * s * s + wbuf_elems(eps)) * sizeof(T);
}

// The output tile side for this launch, or 0 when not even a 32-point tile
// fits the block's shared memory.
template <typename T>
int choose_ot(int eps, int ksteps, bool bf16) {
  const size_t limit = static_cast<size_t>(smem_limit());
  if (superstep_smem<T>(64, eps, ksteps, bf16) <= limit / 2) return 64;
  if (superstep_smem<T>(32, eps, ksteps, bf16) <= limit) return 32;
  return 0;
}

template <typename T, typename OpT, int EPS, int WARPS>
__global__ void __launch_bounds__(32 * WARPS)
superstep2d_fast(const T* __restrict__ u, T* __restrict__ out, int nx, int ny, int K, int ot,
                 T scale, T wsum, T dt) {
  constexpr int RUN = fast_run<T>();
  extern __shared__ __align__(16) unsigned char smem_raw[];
  const int S = ot + 2 * K * EPS;
  T* cur = reinterpret_cast<T*>(smem_raw);
  T* nxt = cur + S * S;
  const int lane = threadIdx.x, warp = threadIdx.y;
  const int x0 = blockIdx.y * ot, y0 = blockIdx.x * ot;  // the output tile
  const int bx0 = x0 - K * EPS, by0 = y0 - K * EPS;      // buffer cell (0, 0)

  for (int idx = warp * 32 + lane; idx < S * S; idx += 32 * WARPS) {
    const int a = idx / S, c = idx - a * S;
    const int x = bx0 + a, y = by0 + c;
    const bool in = x >= 0 && x < nx && y >= 0 && y < ny;
    cp_async_value(cur + idx, in ? u + static_cast<size_t>(x) * ny + y : u, in);
  }
  cp_async_commit();
  cp_async_wait<0>();
  __syncthreads();

#pragma unroll 1
  for (int j = 1; j <= K; ++j) {
    const int band = ot + 2 * (K - j) * EPS;  // level j's band: buffer [j*EPS, j*EPS + band)
    const int lo = (j - 1) * EPS;             // its window: level j-1's band
    const int nstrip = (band + 31) / 32, nrun = (band + RUN - 1) / RUN;
#pragma unroll 1
    for (int item = warp; item < nstrip * nrun; item += WARPS) {
      const int sx = item / nstrip, sy = item - sx * nstrip;
      // the last item of a row (column) ends at the band's edge; the rows
      // (columns) it shares with the item before it are written by that one
      const int ox = min(sx * RUN, band - RUN), oy = min(sy * 32, band - 32);
      const T* col = cur + (lo + ox) * S + lo + oy + lane + EPS;
      T acc[RUN];
      register_sums<T, OpT, EPS, RUN>(col, S, acc);
      const int by = j * EPS + oy + lane, y = by0 + by;
      const bool own_col = oy + lane >= sy * 32;
#pragma unroll
      for (int r = 0; r < RUN; ++r) {
        const int bx = j * EPS + ox + r, x = bx0 + bx;
        if (!own_col || ox + r < sx * RUN) continue;
        const bool inside = x >= 0 && x < nx && y >= 0 && y < ny;
        const int o = bx * S + by;
        const T du = operator_du(acc[r], Operand<T, OpT>::round(cur[o]), scale, wsum);
        const T v = inside ? euler(cur[o], dt, du) : T(0);
        if (j < K)
          nxt[o] = v;
        else if (inside)
          out[static_cast<size_t>(x) * ny + y] = v;
      }
    }
    __syncthreads();  // level j is written before level j+1 reads it
    T* t = cur;
    cur = nxt;
    nxt = t;
  }
}

template <typename T, typename OpT, int EPS, int WARPS>
int launch_warps(const void* u, void* out, int nx, int ny, int ksteps, int ot, size_t smem,
                 double scale, double wsum, double dt, cudaStream_t stream) {
  auto kernel = superstep2d_fast<T, OpT, EPS, WARPS>;
  const int e = allow_smem(kernel, smem);
  if (e != 0) return e;
  const dim3 grid((ny + ot - 1) / ot, (nx + ot - 1) / ot);
  kernel<<<grid, dim3(32, WARPS), smem, stream>>>(
      static_cast<const T*>(u), static_cast<T*>(out), nx, ny, ksteps, ot,
      static_cast<T>(scale), static_cast<T>(wsum), static_cast<T>(dt));
  return static_cast<int>(cudaGetLastError());
}

template <typename T, typename OpT, int EPS>
int launch_fast(const void* u, void* out, int nx, int ny, int ksteps, int ot, double scale,
                double wsum, double dt, cudaStream_t stream) {
  // four warps a block, or six where the shared memory admits just two
  // blocks an SM (K=3 at eps=8 in float32): four warps a block then leave
  // the SM too few to hide the shared-memory reads (six ran faster there on
  // an H100, and slower with one block or three an SM)
  const size_t smem = superstep_smem<T>(ot, EPS, ksteps, false);
  auto four = superstep2d_fast<T, OpT, EPS, 4>;
  int e = allow_smem(four, smem);
  if (e != 0) return e;
  int per_sm = 0;
  e = static_cast<int>(cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, four, 128, smem));
  if (e != 0) return e;
  if (per_sm == 2)
    return launch_warps<T, OpT, EPS, 6>(u, out, nx, ny, ksteps, ot, smem, scale, wsum, dt,
                                        stream);
  return launch_warps<T, OpT, EPS, 4>(u, out, nx, ny, ksteps, ot, smem, scale, wsum, dt,
                                      stream);
}

// Instantiate launch_fast for eps 0..FAST_MAX_EPS by a compile-time switch.
template <typename T, typename OpT, int EPS = 0>
int dispatch_fast(int eps, const void* u, void* out, int nx, int ny, int ksteps, int ot,
                  double scale, double wsum, double dt, cudaStream_t stream) {
  if (eps == EPS)
    return launch_fast<T, OpT, EPS>(u, out, nx, ny, ksteps, ot, scale, wsum, dt, stream);
  if constexpr (EPS < FAST_MAX_EPS)
    return dispatch_fast<T, OpT, EPS + 1>(eps, u, out, nx, ny, ksteps, ot, scale, wsum, dt,
                                          stream);
  return -1;
}

// The shared tile body (stencil_tile.cuh), for eps above FAST_MAX_EPS.
template <typename T, typename OpT, int MW, int K>
__global__ void __launch_bounds__(THREADS)
superstep2d_kernel(const T* __restrict__ u, T* __restrict__ out, int nx, int ny, int eps,
                   int ot, const Plan plan, T scale, T wsum, T dt) {
  constexpr bool BF16 = !std::is_same<T, OpT>::value;
  extern __shared__ __align__(16) unsigned char smem_raw[];
  const int S = ot + 2 * K * eps;
  T* cur = reinterpret_cast<T*>(smem_raw);
  T* nxt = cur + S * S;
  T* opnd = nxt + S * S;  // bf16 tier only
  T* wbuf = opnd + (BF16 ? S * S : 0);
  const int tx = threadIdx.x, ty = threadIdx.y;
  const int x0 = blockIdx.y * ot, y0 = blockIdx.x * ot;  // the output tile
  const int bx0 = x0 - K * eps, by0 = y0 - K * eps;      // buffer cell (0, 0)

  load_window<T, T>(cur, S, S, S, u, nx, ny, bx0, by0);
  __syncthreads();

#pragma unroll 1
  for (int j = 1; j <= K; ++j) {
    const int band = ot + 2 * (K - j) * eps;  // level j's band: buffer [j*eps, j*eps + band)
    const int lo = (j - 1) * eps;             // its window: level j-1's band
    const T* op = cur;
    if constexpr (BF16) {
      const int w = band + 2 * eps;
      const int tid = ty * TILE_Y + tx;
      for (int idx = tid; idx < w * w; idx += THREADS) {
        const int a = idx / w, b = idx - a * w;
        const int o = (lo + a) * S + lo + b;
        opnd[o] = Operand<T, OpT>::round(cur[o]);
      }
      __syncthreads();
      op = opnd;
    }
    const int nsub = (band + TILE_X - 1) / TILE_X;
    for (int sx = 0; sx < nsub; ++sx) {
      for (int sy = 0; sy < nsub; ++sy) {
        const int ox = min(sx * TILE_X, band - TILE_X), oy = min(sy * TILE_Y, band - TILE_Y);
        T acc[ROWS_PER_THREAD];
        window_sums<T, MW>(op + (lo + ox) * S + lo + oy, S, eps, plan, wbuf, acc);
#pragma unroll
        for (int k = 0; k < ROWS_PER_THREAD; ++k) {
          const int bx = j * eps + ox + ty + k * THREADS_Y, by = j * eps + oy + tx;
          const int x = bx0 + bx, y = by0 + by;
          const bool inside = x >= 0 && x < nx && y >= 0 && y < ny;
          const int o = bx * S + by;
          const T du = operator_du(acc[k], op[o], scale, wsum);
          const T v = inside ? euler(cur[o], dt, du) : T(0);
          if (j < K)
            nxt[o] = v;
          else if (inside)
            out[static_cast<size_t>(x) * ny + y] = v;
        }
      }
    }
    __syncthreads();  // level j is written before level j+1 reads it
    T* t = cur;
    cur = nxt;
    nxt = t;
  }
}

template <typename T, typename OpT, int MW, int K>
int launch_k(const void* u, void* out, int nx, int ny, int eps, int ot, double scale,
             double wsum, double dt, void* stream) {
  auto kernel = superstep2d_kernel<T, OpT, MW, K>;
  const size_t smem = superstep_smem<T>(ot, eps, K, !std::is_same<T, OpT>::value);
  const int e = allow_smem(kernel, smem);
  if (e != 0) return e;
  const dim3 block(TILE_Y, THREADS_Y);
  const dim3 grid((ny + ot - 1) / ot, (nx + ot - 1) / ot);
  kernel<<<grid, block, smem, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const T*>(u), static_cast<T*>(out), nx, ny, eps, ot, make_plan(eps),
      static_cast<T>(scale), static_cast<T>(wsum), static_cast<T>(dt));
  return static_cast<int>(cudaGetLastError());
}

template <typename T, typename OpT>
int launch(const void* u, void* out, int nx, int ny, int eps, int ksteps, double scale,
           double wsum, double dt, void* stream) {
  if (eps < 0 || eps > MAX_EPS || ksteps < 1 || ksteps > MAX_K) return -1;
  const int ot = choose_ot<T>(eps, ksteps, !std::is_same<T, OpT>::value);
  if (ot == 0) return -1;
  if ((static_cast<long long>(nx) + ot - 1) / ot > 65535) return -1;  // gridDim.y
  if (nx <= 0 || ny <= 0) return 0;
  if (eps <= FAST_MAX_EPS)
    return dispatch_fast<T, OpT>(eps, u, out, nx, ny, ksteps, ot, scale, wsum, dt,
                                 static_cast<cudaStream_t>(stream));
  auto body = [&](auto mw) {  // the tile body, instantiated only for eps above FAST_MAX_EPS
    constexpr int MW = decltype(mw)::value;
    switch (ksteps) {
      case 1: return launch_k<T, OpT, MW, 1>(u, out, nx, ny, eps, ot, scale, wsum, dt, stream);
      case 2: return launch_k<T, OpT, MW, 2>(u, out, nx, ny, eps, ot, scale, wsum, dt, stream);
      case 3: return launch_k<T, OpT, MW, 3>(u, out, nx, ny, eps, ot, scale, wsum, dt, stream);
      default: return launch_k<T, OpT, MW, 4>(u, out, nx, ny, eps, ot, scale, wsum, dt, stream);
    }
  };
  if (eps <= 16) return body(std::integral_constant<int, wrows_for(16)>{});
  if (eps <= 32) return body(std::integral_constant<int, wrows_for(32)>{});
  return body(std::integral_constant<int, wrows_for(MAX_EPS)>{});
}

}  // namespace

// dtype: 0 = float32, 1 = float64.  bf16: 1 selects the bfloat16 operand
// tier.  u and out are (nx, ny) states that must not overlap.
extern "C" int nlheat_superstep2d(int dtype, int bf16, const void* u, void* out, int nx,
                                  int ny, int eps, int ksteps, double scale, double wsum,
                                  double dt, void* stream) {
  if (dtype == 0)
    return (bf16 ? &launch<float, __nv_bfloat16> : &launch<float, float>)(
        u, out, nx, ny, eps, ksteps, scale, wsum, dt, stream);
  if (dtype == 1)
    return (bf16 ? &launch<double, __nv_bfloat16> : &launch<double, double>)(
        u, out, nx, ny, eps, ksteps, scale, wsum, dt, stream);
  return -1;
}

// The output tile side a K-step launch would use at this eps, dtype and
// tier (64 or 32), or 0 when it does not fit the card's shared memory.
extern "C" int nlheat_superstep2d_fits(int dtype, int bf16, int eps, int ksteps) {
  if (eps < 0 || eps > MAX_EPS || ksteps < 1 || ksteps > MAX_K) return 0;
  if (dtype == 0) return choose_ot<float>(eps, ksteps, bf16 != 0);
  if (dtype == 1) return choose_ot<double>(eps, ksteps, bf16 != 0);
  return 0;
}
