// K forward-Euler steps of B independent 2D solves per launch, by
// trapezoidal temporal blocking, for NVIDIA Hopper (sm_90a).
//
// Replaces the Pallas TPU kernel
//   batched_superstep2d <- nonlocalheatequation_tpu/ops/pallas_kernel.py:
//                          _build_batched_superstep_kernel
//                          (make_batched_superstep_multi_step_fn)
//
// The stack is (B, nx, ny), unpadded.  The grid is superstep2d's lattice of
// OT x OT output tiles over one plane with the case index as blockIdx.z,
// and each block runs superstep2d's levels on its case: the window widened
// by K*eps per side in shared memory, K levels of bands shrinking by eps
// per side, each masked to the domain and computed as 32 x 32 sub-tiles by
// the tile body of stencil_tile.cuh, the bf16 tier rounding each level's
// operand band into a third buffer.  Same levels, masks and order per case,
// so lane b is bit-identical to one superstep2d launch of the same K on
// case b, hence to K step2d launches.
//
// Per-case physics: each case reads its (scale, dt) from a (B, 2) table in
// the state type (see batched_step2d.cu), and one launch serves uniform and
// mixed chunks alike.  Production form only.
//
// What bounds it on an H100 SXM (published peaks, computed, not measured):
// one stack read and one written per launch (about 20 us at 8 x 1024^2,
// eps=8, f32), against K times the step's operations (about 5 us each)
// plus the redundant bands (1.63x at K=2, 1.83x at K=3 with OT = 64); as
// for superstep2d, the tuner decides where it pays.
//
// Plain C interface (ops/_build.py, ops/cuda_batched.py): launches on the
// given stream, allocates nothing, returns cudaGetLastError() or -1 when K,
// eps, the shared memory, the grid or the case count is beyond the
// kernel's limits.  nlheat_batched_superstep2d_fits is the fit gate: the
// output tile side, or 0.

#include "stencil_tile.cuh"

namespace {

using namespace nlheat;

constexpr int MAX_K = 4;
constexpr int MAX_CASES = 65535;  // gridDim.z

template <typename T>
size_t superstep_smem(int ot, int eps, int ksteps, bool bf16) {
  const size_t s = ot + 2 * ksteps * eps;
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

template <typename T, typename OpT, int MW, int K>
__global__ void __launch_bounds__(THREADS)
batched_superstep2d_kernel(const T* __restrict__ u, T* __restrict__ out, int nx, int ny,
                           int eps, int ot, const Plan plan, const T* __restrict__ params,
                           T wsum) {
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
  const int b = blockIdx.z;
  const size_t base = static_cast<size_t>(b) * nx * ny;  // case b's plane
  const T scale = params[2 * b], dt = params[2 * b + 1];

  load_window<T, T>(cur, S, S, S, u + base, nx, ny, bx0, by0);
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
        const int a = idx / w, c = idx - a * w;
        const int o = (lo + a) * S + lo + c;
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
            out[base + static_cast<size_t>(x) * ny + y] = v;
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
int launch_k(const void* u, void* out, const void* params, int batch, int nx, int ny, int eps,
             int ot, double wsum, void* stream) {
  auto kernel = batched_superstep2d_kernel<T, OpT, MW, K>;
  const size_t smem = superstep_smem<T>(ot, eps, K, !std::is_same<T, OpT>::value);
  const int e = allow_smem(kernel, smem);
  if (e != 0) return e;
  const dim3 block(TILE_Y, THREADS_Y);
  const dim3 grid((ny + ot - 1) / ot, (nx + ot - 1) / ot, batch);
  kernel<<<grid, block, smem, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const T*>(u), static_cast<T*>(out), nx, ny, eps, ot, make_plan(eps),
      static_cast<const T*>(params), static_cast<T>(wsum));
  return static_cast<int>(cudaGetLastError());
}

template <typename T, typename OpT>
int launch(const void* u, void* out, const void* params, int batch, int nx, int ny, int eps,
           int ksteps, double wsum, void* stream) {
  if (eps < 0 || eps > MAX_EPS || ksteps < 1 || ksteps > MAX_K) return -1;
  if (batch < 0 || batch > MAX_CASES) return -1;
  const int ot = choose_ot<T>(eps, ksteps, !std::is_same<T, OpT>::value);
  if (ot == 0) return -1;
  if ((static_cast<long long>(nx) + ot - 1) / ot > 65535) return -1;  // gridDim.y
  if (batch == 0 || nx <= 0 || ny <= 0) return 0;
  return with_mw(eps, [&](auto mw) {
    constexpr int MW = decltype(mw)::value;
    switch (ksteps) {
      case 1:
        return launch_k<T, OpT, MW, 1>(u, out, params, batch, nx, ny, eps, ot, wsum, stream);
      case 2:
        return launch_k<T, OpT, MW, 2>(u, out, params, batch, nx, ny, eps, ot, wsum, stream);
      case 3:
        return launch_k<T, OpT, MW, 3>(u, out, params, batch, nx, ny, eps, ot, wsum, stream);
      default:
        return launch_k<T, OpT, MW, 4>(u, out, params, batch, nx, ny, eps, ot, wsum, stream);
    }
  });
}

}  // namespace

// dtype: 0 = float32, 1 = float64.  bf16: 1 selects the bfloat16 operand
// tier.  u and out are (batch, nx, ny) stacks that must not overlap; params
// is the (batch, 2) table of each case's (scale, dt) in the state type.
extern "C" int nlheat_batched_superstep2d(int dtype, int bf16, const void* u, void* out,
                                          const void* params, int batch, int nx, int ny,
                                          int eps, int ksteps, double wsum, void* stream) {
  if (dtype == 0)
    return (bf16 ? &launch<float, __nv_bfloat16> : &launch<float, float>)(
        u, out, params, batch, nx, ny, eps, ksteps, wsum, stream);
  if (dtype == 1)
    return (bf16 ? &launch<double, __nv_bfloat16> : &launch<double, double>)(
        u, out, params, batch, nx, ny, eps, ksteps, wsum, stream);
  return -1;
}

// The output tile side a K-step launch would use at this eps, dtype and
// tier (64 or 32), or 0 when it does not fit the card's shared memory.
extern "C" int nlheat_batched_superstep2d_fits(int dtype, int bf16, int eps, int ksteps) {
  if (eps < 0 || eps > MAX_EPS || ksteps < 1 || ksteps > MAX_K) return 0;
  if (dtype == 0) return choose_ot<float>(eps, ksteps, bf16 != 0);
  if (dtype == 1) return choose_ot<double>(eps, ksteps, bf16 != 0);
  return 0;
}
