// The neighbour sum of one block of a distributed 2D solve with the halo
// exchange inside the kernel, for NVIDIA Hopper (sm_90a).
//
// Replaces the Pallas TPU kernel of nonlocalheatequation_tpu
//   fused_nsum2d  <- ops/pallas_halo.py:build_fused_nsum_2d (body
//                    _build_rdma_kernel :511): the block's bands arrive by
//                    remote DMA inside the kernel, the interior is summed
//                    while they fly, then the eps-wide ring
// The input is the block itself and the blocks around it on the mesh, as
// device pointers: table[(ox+hx)*(2hy+1) + (oy+hy)] is the block at mesh
// offset (ox, oy) from this one, |ox| <= hx, |oy| <= hy (the hop caps of
// the exchange plan, ops/cuda_halo.plan_exchange), null where that block is
// beyond the mesh.  Every block is (bx, by), row-major.  The output is the
// (bx, by) sum over the masked circle.  The blocks may sit on one card (the
// virtual devices of a mesh) or on other cards whose memory this one reads
// over NVLink (peer access, enabled by nlheat_enable_peer); the caller
// orders the launch after the neighbours' last writes and before their
// next ones.
//
// Design.  There is no halo frame and no band copy: a tile reads its
// (32+2eps)^2 window of the virtual frame straight from the blocks that
// hold it.  Frame cell (x, y), in this block's coordinates with x, y in
// [-eps, b+eps), is cell (x mod bx, y mod by) of the block at offset
// (floor(x/bx), floor(y/by)); cells beyond the mesh are 0, the volumetric
// boundary condition, as the collective exchange leaves them.  A tile whose
// window lies inside this block (the interior, the TPU kernel's first
// phase) loads from it alone; the others (the ring) resolve each cell's
// block.  One launch covers every 32 x 32 tile of the block on nsum2d's
// lattice, and runs nsum2d's tile body (stencil_tile.cuh), whose sum order
// is fixed by the stencil plan: so the result is bitwise nsum2d on the
// halo-exchanged frame, which is the JAX package's contract for the fused
// path (tests/test_halo_fused.py).  On a TPU the interior hides the DMA;
// here the ring tiles' reads of the neighbours are the exchange, spread
// over the launch.  Types: float or double, operand the state type or
// __nv_bfloat16.
//
// What bounds it on an H100 SXM (NVIDIA's published peaks at the card's
// 700 W limit: 3.35 TB/s HBM3, 67 TFLOP/s f32 outside the tensor cores;
// computed bounds, not measurements): it reads the block and its halo once
// and writes the block once, 2 x 16 MiB for a 2048^2 f32 block at eps=8,
// about 10 us, above the tile body's 41 adds per point (about 2.6 us).
//
// Plain C interface (loaded with ctypes by ops/_build.py and wrapped in
// ops/cuda_halo.py).  The entry point launches on the given stream,
// allocates nothing and returns cudaGetLastError() (0 = launched), or -1
// when eps, the shared-memory tile, the neighbour table or the grid is
// beyond what the kernel supports.

#include "stencil_tile.cuh"

namespace {

using namespace nlheat;

// The neighbour table, passed by value (kernel parameter space): at most
// 125 blocks, 11 x 11 in 2D (hops up to 5 per axis).
constexpr int MAX_NB = 125;

struct Neighbours {
  const void* p[MAX_NB];
  int hx, hy;
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

// Copy the rows x cols window whose cell (a, b) is frame cell (r0 + a,
// c0 + b) into shared memory, reading each cell from the block that holds
// it; 0 beyond the frame or the mesh; rounded to the operand type.
template <typename T, typename OpT>
__device__ void load_window_mesh(T* win, int ld, int rows, int cols, const Neighbours& nb,
                                 int bx, int by, int eps, int r0, int c0) {
  const int tid = threadIdx.y * TILE_Y + threadIdx.x;
  const int ny = 2 * nb.hy + 1;
  for (int idx = tid; idx < rows * cols; idx += THREADS) {
    const int a = idx / cols, b = idx - a * cols;
    const int x = r0 + a, y = c0 + b;
    T v = T(0);
    if (x >= -eps && x < bx + eps && y >= -eps && y < by + eps) {
      int ox, lx, oy, ly;
      locate(x, bx, ox, lx);
      locate(y, by, oy, ly);
      if (ox >= -nb.hx && ox <= nb.hx && oy >= -nb.hy && oy <= nb.hy) {
        const T* blk = static_cast<const T*>(nb.p[(ox + nb.hx) * ny + oy + nb.hy]);
        if (blk != nullptr) v = blk[static_cast<size_t>(lx) * by + ly];
      }
    }
    win[a * ld + b] = Operand<T, OpT>::round(v);
  }
}

template <typename T, typename OpT, int MW>
__global__ void __launch_bounds__(THREADS)
fused_nsum2d_kernel(T* __restrict__ out, int bx, int by, int eps, const Plan plan,
                    const Neighbours nb) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  const int wc = TILE_Y + 2 * eps, wr = TILE_X + 2 * eps;
  T* tile = reinterpret_cast<T*>(smem_raw);
  T* wbuf = tile + wr * wc;
  const int tx = threadIdx.x, ty = threadIdx.y;
  const int x0 = blockIdx.y * TILE_X, y0 = blockIdx.x * TILE_Y;

  // output (x, y) reads frame cells x-eps .. x+eps, y-eps .. y+eps
  const int r0 = x0 - eps, c0 = y0 - eps;
  if (r0 >= 0 && r0 + wr <= bx && c0 >= 0 && c0 + wc <= by) {
    const T* own = static_cast<const T*>(nb.p[nb.hx * (2 * nb.hy + 1) + nb.hy]);
    load_window<T, OpT>(tile, wc, wr, wc, own, bx, by, r0, c0);
  } else {
    load_window_mesh<T, OpT>(tile, wc, wr, wc, nb, bx, by, eps, r0, c0);
  }
  __syncthreads();
  T acc[ROWS_PER_THREAD];
  window_sums<T, MW>(tile, wc, eps, plan, wbuf, acc);

#pragma unroll
  for (int k = 0; k < ROWS_PER_THREAD; ++k) {
    const int x = x0 + ty + k * THREADS_Y, y = y0 + tx;
    if (x < bx && y < by) out[static_cast<size_t>(x) * by + y] = acc[k];
  }
}

template <typename T, typename OpT, int MW>
int launch_mw(void* out, int bx, int by, int eps, const Neighbours& nb, void* stream) {
  const size_t smem = tile_smem_bytes<T>(eps);
  auto kernel = fused_nsum2d_kernel<T, OpT, MW>;
  const int e = allow_smem(kernel, smem);
  if (e != 0) return e;
  const dim3 grid((by + TILE_Y - 1) / TILE_Y, (bx + TILE_X - 1) / TILE_X);
  kernel<<<grid, dim3(TILE_Y, THREADS_Y), smem, static_cast<cudaStream_t>(stream)>>>(
      static_cast<T*>(out), bx, by, eps, make_plan(eps), nb);
  return static_cast<int>(cudaGetLastError());
}

template <typename T, typename OpT>
int launch(void* out, int bx, int by, int eps, const Neighbours& nb, void* stream) {
  if (eps < 0 || eps > MAX_EPS) return -1;
  if (tile_smem_bytes<T>(eps) > static_cast<size_t>(smem_limit())) return -1;
  if ((static_cast<long long>(bx) + TILE_X - 1) / TILE_X > 65535) return -1;  // gridDim.y
  if (bx <= 0 || by <= 0) return 0;
  return with_mw(eps, [&](auto mw) {
    return launch_mw<T, OpT, decltype(mw)::value>(out, bx, by, eps, nb, stream);
  });
}

}  // namespace

// dtype: 0 = float32, 1 = float64.  bf16: 1 selects the bfloat16 operand tier.
// table: (2hx+1)*(2hy+1) block pointers (see the top of this file), the
// centre entry this block's.
extern "C" int nlheat_fused_nsum2d(int dtype, int bf16, const void* const* table, int hx,
                                   int hy, void* out, int bx, int by, int eps, void* stream) {
  if (hx < 0 || hy < 0 || (2 * hx + 1) * (2 * hy + 1) > MAX_NB) return -1;
  Neighbours nb{};
  for (int i = 0; i < (2 * hx + 1) * (2 * hy + 1); ++i) nb.p[i] = table[i];
  nb.hx = hx;
  nb.hy = hy;
  if (nb.p[hx * (2 * hy + 1) + hy] == nullptr) return -1;
  if (dtype == 0)
    return (bf16 ? &launch<float, __nv_bfloat16> : &launch<float, float>)(out, bx, by, eps, nb,
                                                                          stream);
  if (dtype == 1)
    return (bf16 ? &launch<double, __nv_bfloat16> : &launch<double, double>)(out, bx, by, eps,
                                                                             nb, stream);
  return -1;
}

// Let the current card read the memory of card `peer` (NVLink or PCIe peer
// access), for a mesh whose blocks sit on several cards.  0 when access is
// on (already on counts), else the CUDA error.
extern "C" int nlheat_enable_peer(int device, int peer) {
  if (device == peer) return 0;
  int dev = 0;
  cudaGetDevice(&dev);
  cudaSetDevice(device);
  cudaError_t e = cudaDeviceEnablePeerAccess(peer, 0);
  if (e == cudaErrorPeerAccessAlreadyEnabled) {
    cudaGetLastError();  // clear the (non-sticky) error state
    e = cudaSuccess;
  }
  cudaSetDevice(dev);
  return static_cast<int>(e);
}
