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
// There is no halo frame and no band copy: a tile reads its window of the
// virtual frame straight from the blocks that hold it.  Frame cell (x, y),
// in this block's coordinates with x, y in [-eps, b+eps), is cell (x mod bx,
// y mod by) of the block at offset (floor(x/bx), floor(y/by)); cells beyond
// the mesh are 0, the volumetric boundary condition, as the collective
// exchange leaves them.  The window is summed in nsum2d's order (the tile
// body of stencil_tile.cuh, or register_sums, which adds the same terms in
// the same order), so the result is bitwise nsum2d on the halo-exchanged
// frame, which is the JAX package's contract for the fused path
// (tests/test_halo_fused.py).  On a TPU the interior hides the DMA; here the
// ring tiles' reads of the neighbours are the exchange, spread over the
// launch.  Types: float or double, operand the state type or __nv_bfloat16.
//
// Design, for 0 <= eps <= FAST_MAX_EPS (10): batched_step2d.cu's register
// design in the nsum form.  A persistent grid walks the block's tiles of
// RUN*4 rows x 32 columns (RUN = 32 in float32, 16 in float64); a block of
// 32 x 4 threads stages the next tile's (tile + 2eps)^2 window by cp.async
// into one of two shared-memory buffers while it sums the current one.  The
// window load is the exchange:
//   * the window's first row and column are resolved once (a floor
//     division an axis: block offset and coordinate); every other cell's
//     block steps from them across the block edges it passes (a compare a
//     row or column inside the block, one step beyond it), so no cell
//     divides, and cells beyond the mesh, a null table entry or the frame
//     are zero-filled by the copy;
//   * a tile whose window columns lie inside this block's (the interior,
//     85% of the tiles of a 2048^2 block at eps=8 in float32, and the
//     ring's first and last rows of tiles, 12% more) reads each window row
//     from one block, the row's entry of the table, 16 bytes a copy, where
//     every block's rows and the window's origin are 16-byte aligned (eps a
//     multiple of 4 in float32, even in float64, by a multiple of the same);
//   * any other tile (unaligned, across a block edge in y, degenerate
//     blocks with a side of 2eps or less, multi-hop windows with eps above
//     the block edge) copies cell by cell, each cell's row and column
//     stepped as above.
// Each thread then sums one column of RUN outputs with W_h of its RUN + 2eps
// window rows in registers (register_sums; eps a template parameter), with
// no sum buffer and no barrier inside the sum.  The bf16 tier rounds the
// staged window in place once.  Above eps 10, one 32 x 32 tile a block:
// the window loaded cell by cell, each ring cell's block resolved on its own
// (two floor divisions), then the tile body (window_sums).
//
// What bounds it on an H100 SXM (NVIDIA's published peaks at the card's
// 700 W limit: 3.35 TB/s HBM3, 67 TFLOP/s f32 outside the tensor cores;
// computed bounds, not measurements): it reads the block and its halo once
// and writes the block once, 2 x 16 MiB for a 2048^2 f32 block at eps=8,
// about 10 us, above the 41 adds per point (about 2.6 us).  Inside the SM
// the column sums' shared-memory reads come next: about 2eps(RUN+2eps)/RUN
// a point (26 at eps=8, f32) and two for the staging.
//
// Plain C interface (loaded with ctypes by ops/_build.py and wrapped in
// ops/cuda_halo.py).  The entry point launches on the given stream,
// allocates nothing and returns cudaGetLastError() (0 = launched), or -1
// when eps, the shared-memory tile, the neighbour table or the grid is
// beyond what the kernel supports.

#include "stencil_tile.cuh"

#include <cstdint>

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

// -- the register design, eps <= FAST_MAX_EPS ------------------------------------

constexpr int FAST_MAX_EPS = 10;

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

// Stage the window of the tile at (x0, y0): cell (a, c) is frame cell (x0 -
// EPS + a, y0 - EPS + c), 0 beyond the frame, the mesh or a null table
// entry.  The window's first row and column are resolved once (a floor
// division an axis), every other cell's block and coordinates stepped from
// them.  vec: every block's rows and the windows' origins are 16-byte
// aligned (from the host); without it every window copies cell by cell.
template <typename T, int EPS>
__device__ void stage_window(T* buf, const Neighbours& nb, int bx, int by, int x0, int y0,
                             bool vec) {
  constexpr int WR = RegTile<T>::ROWS + 2 * EPS, WC = RegTile<T>::COLS + 2 * EPS;
  const int r0 = x0 - EPS, c0 = y0 - EPS;
  const int nyt = 2 * nb.hy + 1;
  const T* own = static_cast<const T*>(nb.p[nb.hx * nyt + nb.hy]);
  const int tid = threadIdx.y * 32 + threadIdx.x;
  int ox0, lx0, oy0, ly0;
  locate(r0, bx, ox0, lx0);
  locate(c0, by, oy0, ly0);
  if (vec && c0 >= 0 && c0 + WC <= by) {
    // the window's columns lie inside the block's (the interior tiles and
    // the ring's first and last rows of tiles): one source block a window
    // row, the row's entry of this block's column of the table, 16 bytes
    // a copy
    const void* const* col = nb.p + nb.hy;
    constexpr int V = vec_width<T>(), PER_ROW = WC / V;
    for (int idx = tid; idx < WR * PER_ROW; idx += REG_THREADS) {
      const int a = idx / PER_ROW, c = (idx - a * PER_ROW) * V;
      int ox = ox0, lx = lx0;
      step_to(a, bx, ox, lx);
      const int x = r0 + a;
      const T* src = nullptr;
      if (x >= -EPS && x < bx + EPS && ox >= -nb.hx && ox <= nb.hx) {
        src = static_cast<const T*>(col[(ox + nb.hx) * nyt]);
        if (src != nullptr) src += static_cast<size_t>(lx) * by + c0 + c;
      }
      cp_async_16(buf + a * WC + c, src == nullptr ? own : src, src != nullptr);
    }
    return;
  }
  // a window across a block edge in y, an unaligned one (and degenerate
  // and multi-hop blocks): cell by cell, each stepped from the first row
  // and column
  for (int idx = tid; idx < WR * WC; idx += REG_THREADS) {
    const int a = idx / WC, c = idx - a * WC;
    int ox = ox0, lx = lx0, oy = oy0, ly = ly0;
    step_to(a, bx, ox, lx);
    step_to(c, by, oy, ly);
    const int x = r0 + a, y = c0 + c;
    const T* blk = nullptr;
    if (x >= -EPS && x < bx + EPS && y >= -EPS && y < by + EPS && ox >= -nb.hx &&
        ox <= nb.hx && oy >= -nb.hy && oy <= nb.hy)
      blk = static_cast<const T*>(nb.p[(ox + nb.hx) * nyt + oy + nb.hy]);
    cp_async_value(buf + idx, blk == nullptr ? own : blk + static_cast<size_t>(lx) * by + ly,
                   blk != nullptr);
  }
}

template <typename T, int EPS>
__global__ void __launch_bounds__(REG_THREADS)
fused_nsum2d_fast(T* __restrict__ out, int bx, int by, int nty, int ntiles, bool vec, bool bf16,
                  const Neighbours nb) {
  constexpr int RUN = RegTile<T>::RUN, ROWS = RegTile<T>::ROWS, COLS = RegTile<T>::COLS;
  constexpr int WC = COLS + 2 * EPS;
  constexpr int BUF = static_cast<int>(reg_window_elems<T, EPS>());
  extern __shared__ __align__(16) unsigned char smem_raw[];
  T* bufs = reinterpret_cast<T*>(smem_raw);
  const int tx = threadIdx.x, r0 = threadIdx.y * RUN;

  int t = blockIdx.x;
  if (t < ntiles) stage_window<T, EPS>(bufs, nb, bx, by, t / nty * ROWS, t % nty * COLS, vec);
  cp_async_commit();
  int cur = 0;
  for (; t < ntiles; t += gridDim.x) {
    const int tn = t + gridDim.x;
    if (tn < ntiles)
      stage_window<T, EPS>(bufs + (cur ^ 1) * BUF, nb, bx, by, tn / nty * ROWS,
                           tn % nty * COLS, vec);
    cp_async_commit();
    cp_async_wait<1>();  // this tile's copies have landed (the next tile's may not)
    __syncthreads();
    T* win = bufs + cur * BUF;
    if (bf16) {
      for (int idx = threadIdx.y * 32 + tx; idx < BUF; idx += REG_THREADS)
        win[idx] = Operand<T, __nv_bfloat16>::round(win[idx]);
      __syncthreads();
    }
    T acc[RUN];
    register_sums<T, T, EPS, RUN>(win + r0 * WC + tx + EPS, WC, acc);
    const int x0 = t / nty * ROWS, y = t % nty * COLS + tx;
#pragma unroll
    for (int r = 0; r < RUN; ++r) {
      const int x = x0 + r0 + r;
      if (x < bx && y < by) out[static_cast<size_t>(x) * by + y] = acc[r];
    }
    __syncthreads();  // every read of this buffer is done before it is staged again
    cur ^= 1;
  }
  cp_async_wait<0>();
}

template <typename T, int EPS>
int launch_fast(void* out, int bx, int by, bool bf16, const Neighbours& nb, cudaStream_t st) {
  auto kernel = fused_nsum2d_fast<T, EPS>;
  const size_t smem = 2 * reg_window_elems<T, EPS>() * sizeof(T);
  const int e = allow_smem(kernel, smem);
  if (e != 0) return e;
  // blocks an SM holds, asked once per instantiation (one card type a process)
  static int per_sm = -1;
  if (per_sm < 0) {
    int n = 0;
    const cudaError_t err =
        cudaOccupancyMaxActiveBlocksPerMultiprocessor(&n, kernel, REG_THREADS, smem);
    if (err != cudaSuccess) return static_cast<int>(err);
    per_sm = n > 0 ? n : 1;
  }
  const int ntx = (bx + RegTile<T>::ROWS - 1) / RegTile<T>::ROWS;
  const int nty = (by + RegTile<T>::COLS - 1) / RegTile<T>::COLS;
  const long long ntiles = static_cast<long long>(ntx) * nty;
  if (ntiles > 0x7fffffffLL) return -1;
  static const int sms = device_attr(cudaDevAttrMultiProcessorCount);
  const long long grid = ntiles < static_cast<long long>(per_sm) * sms
                             ? ntiles : static_cast<long long>(per_sm) * sms;
  constexpr int V = vec_width<T>();
  bool vec = EPS % V == 0 && by % V == 0;
  for (int i = 0; i < (2 * nb.hx + 1) * (2 * nb.hy + 1); ++i)
    vec = vec && reinterpret_cast<uintptr_t>(nb.p[i]) % 16 == 0;
  kernel<<<static_cast<unsigned>(grid), dim3(32, REG_TY), smem, st>>>(
      static_cast<T*>(out), bx, by, nty, static_cast<int>(ntiles), vec, bf16, nb);
  return static_cast<int>(cudaGetLastError());
}

// -- the tile body, eps above FAST_MAX_EPS ------------------------------------------

template <typename T, typename OpT, int MW>
__global__ void __launch_bounds__(THREADS)
fused_nsum2d_tile(T* __restrict__ out, int bx, int by, int eps, const Plan plan,
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

template <typename T, typename OpT>
int launch_tile(void* out, int bx, int by, int eps, const Neighbours& nb, cudaStream_t st) {
  const size_t smem = tile_smem_bytes<T>(eps);
  if (smem > static_cast<size_t>(smem_limit())) return -1;
  if ((static_cast<long long>(bx) + TILE_X - 1) / TILE_X > 65535) return -1;  // gridDim.y
  auto body = [&](auto mw) {
    auto kernel = fused_nsum2d_tile<T, OpT, decltype(mw)::value>;
    const int e = allow_smem(kernel, smem);
    if (e != 0) return e;
    const dim3 grid((by + TILE_Y - 1) / TILE_Y, (bx + TILE_X - 1) / TILE_X);
    kernel<<<grid, dim3(TILE_Y, THREADS_Y), smem, st>>>(static_cast<T*>(out), bx, by, eps,
                                                         make_plan(eps), nb);
    return static_cast<int>(cudaGetLastError());
  };
  // eps above FAST_MAX_EPS only
  if (eps <= 16) return body(std::integral_constant<int, wrows_for(16)>{});
  if (eps <= 32) return body(std::integral_constant<int, wrows_for(32)>{});
  return body(std::integral_constant<int, wrows_for(MAX_EPS)>{});
}

// The register design where eps allows it, else the tile body.
template <typename T>
int launch(bool bf16, void* out, int bx, int by, int eps, const Neighbours& nb, void* stream) {
  if (eps < 0 || eps > MAX_EPS) return -1;
  if (tile_smem_bytes<T>(eps) > static_cast<size_t>(smem_limit())) return -1;
  if (bx <= 0 || by <= 0) return 0;
  const auto st = static_cast<cudaStream_t>(stream);
  if (eps <= FAST_MAX_EPS)
    return with_eps<FAST_MAX_EPS>(eps, [&](auto e) {
      return launch_fast<T, decltype(e)::value>(out, bx, by, bf16, nb, st);
    });
  return bf16 ? launch_tile<T, __nv_bfloat16>(out, bx, by, eps, nb, st)
              : launch_tile<T, T>(out, bx, by, eps, nb, st);
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
  if (dtype == 0) return launch<float>(bf16 != 0, out, bx, by, eps, nb, stream);
  if (dtype == 1) return launch<double>(bf16 != 0, out, bx, by, eps, nb, stream);
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
