// K forward-Euler steps per launch by trapezoidal temporal blocking, for
// NVIDIA Hopper (sm_90a).
//
// Replaces the Pallas TPU kernel
//   superstep2d <- nonlocalheatequation_tpu/ops/pallas_kernel.py:_build_superstep_kernel
//                  (make_superstep_multi_step_fn)
//
// Each block owns an OT x OT output tile (OT = 64 or 32, a multiple of the
// 32 x 32 tile body) of the unpadded (nx, ny) state.  It loads the window
// widened by K*eps on every side, S = OT + 2K*eps, into shared memory, then
// advances it K levels there: level j computes the band of side
// OT + 2(K-j)*eps centred on the tile, as 32 x 32 sub-tiles (the last one
// of a row or column shifted back to end at the band's edge), each by the
// tile body of stencil_tile.cuh.  Every level's band is masked to the
// domain (0 outside), which is the volumetric boundary condition re-applied
// every level, so a level's values are exactly what the per-step kernel
// gives after j steps: K levels are bit-identical to K step2d launches.
// Only level K, the output tile, is written to device memory.
//
// Redundant work: the levels compute sum_j ceil((OT + 2(K-j)eps)/32)^2
// sub-tiles for K*(OT/32)^2 of output; at eps=8 that is 1.63x at K=2 and
// 1.83x at K=3 with OT=64, 2.50x and 3.00x with OT=32.  OT is 64 where the
// two state buffers fit in half the block opt-in limit (two blocks per SM),
// else 32.
//
// bf16 tier: the state buffers stay in full precision; before each level
// the band it reads is rounded to bf16 into a third buffer, which the sums
// and the operator's centre read, while the carry reads the unrounded
// state: each level rounds only its operator's operand, as the per-step
// bf16 tier does.
//
// What bounds it on an H100 SXM (published peaks, computed, not measured):
// one state read and one written per launch, so K steps move the bytes of
// one (about 40 us at 4096^2, eps=8, f32); the operations are K times the
// step's (about 10 us each) plus the redundant bands.  The kernel is meant
// for the regime where bytes bind a step; measured on an H100, step2d is
// not held by bytes at 4096^2 (PERF.md), so there the tuner decides.
//
// Plain C interface (ops/_build.py, ops/cuda_kernel.py): launches on the
// given stream, allocates nothing, returns cudaGetLastError() or -1 when K,
// eps, the shared memory or the grid is beyond the kernel's limits.
// nlheat_superstep2d_fits is the fit gate: the output tile side, or 0.

#include "stencil_tile.cuh"

namespace {

using namespace nlheat;

constexpr int MAX_K = 4;

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
  return with_mw(eps, [&](auto mw) {
    constexpr int MW = decltype(mw)::value;
    switch (ksteps) {
      case 1: return launch_k<T, OpT, MW, 1>(u, out, nx, ny, eps, ot, scale, wsum, dt, stream);
      case 2: return launch_k<T, OpT, MW, 2>(u, out, nx, ny, eps, ot, scale, wsum, dt, stream);
      case 3: return launch_k<T, OpT, MW, 3>(u, out, nx, ny, eps, ot, scale, wsum, dt, stream);
      default: return launch_k<T, OpT, MW, 4>(u, out, nx, ny, eps, ot, scale, wsum, dt, stream);
    }
  });
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
