// Footprint-conflict tables over bit-packed address sets, for Hopper (sm_90a).
//
//   pair:   out[i, j] = any_w(foot[i, w] & write[j, w])          (M, N)
//   delta:  the same verdict where live[i] | live[j], old[i, j] elsewhere (K, K)
//
// Replaces the two Pallas kernels of repro/kernels/conflict.py:
//   pot_conflict_pair  <- _conflict_kernel        (conflict_matrix_bits_pair)
//   pot_conflict_delta <- _conflict_delta_kernel  (conflict_matrix_bits_delta)
//
// What bounds it on this card: integer ALU work.  Every output entry ANDs
// W words of its footprint row against W words of the write row and ORs
// the results, M*N*W word pairs; the inputs are only (M + N)*W words, each
// reused N (or M) times.  At the main path's shapes (K = 1024 rows,
// W = 32768 words) that is 3.4e10 word pairs against 268 MB of input: the
// bytes take 0.08 ms at 3.35 TB/s, the word pairs about 2 ms at the int32
// rate, so the operations bound it by a factor of 25.
//
// What the design does about it: each block owns a 64 x 64 output tile and
// walks the W axis inside the block in chunks of 32 words.  A chunk of the
// tile's 64 footprint rows and 64 write rows is staged in shared memory
// once, then each of the 256 threads keeps a 4 x 4 register tile of
// accumulators and, per 4 words, reads 4 + 4 int4 vectors from shared
// memory for 64 and-or steps (one LOP3 each: acc | (a & b)), so the ALU and
// not shared memory is the busy unit.  Threads own rows ty + 16 i and
// columns tx + 16 j, so the eight threads of a quarter-warp read eight
// consecutive rows (row stride 36 words) and hit distinct banks.  Blocks
// run in any order and nothing carries across them; the ragged M, N and W
// edges are masked in the kernel (loaded as zeros, never stored), so the
// caller pads nothing.  The delta kernel tests its tile's live rows and
// columns first: a tile with none copies old and skips the W loop.
//
// Tables are bool (one byte, 0 or 1).  Each entry point returns
// cudaGetLastError() so the Python wrapper can refuse a failed launch.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int TILE = 64;          // output rows and columns per block
constexpr int CHUNK = 32;         // words of W staged per step
constexpr int STRIDE = CHUNK + 4; // shared row stride (16-byte aligned)
constexpr int THREADS = 256;      // 16 x 16 threads, 4 x 4 outputs each

struct Tile {
  int a[TILE][STRIDE];
  int b[TILE][STRIDE];
};

// acc[i][j] = OR over w of (foot[row0 + ty + 16 i, w] & write[col0 + tx + 16 j, w])
__device__ __forceinline__ void intersect_tile(
    const int* __restrict__ foot, const int* __restrict__ write, int m, int n,
    int w, int row0, int col0, Tile& s, int acc[4][4]) {
  const int t = threadIdx.x;
  const int tx = t % 16, ty = t / 16;
  for (int w0 = 0; w0 < w; w0 += CHUNK) {
    // stage 64 rows x 32 words of each operand; a warp reads one row's
    // 32 consecutive words (128 bytes) and stores them to one shared row
#pragma unroll
    for (int i = 0; i < TILE * CHUNK / THREADS; ++i) {
      const int e = t + i * THREADS;
      const int r = e / CHUNK, c = e % CHUNK;
      const int wc = w0 + c;
      const int fr = row0 + r, wr = col0 + r;
      s.a[r][c] = (fr < m && wc < w) ? foot[(int64_t)fr * w + wc] : 0;
      s.b[r][c] = (wr < n && wc < w) ? write[(int64_t)wr * w + wc] : 0;
    }
    __syncthreads();
#pragma unroll 2
    for (int k = 0; k < CHUNK; k += 4) {
      int4 av[4], bv[4];
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        av[i] = *reinterpret_cast<const int4*>(&s.a[ty + 16 * i][k]);
        bv[i] = *reinterpret_cast<const int4*>(&s.b[tx + 16 * i][k]);
      }
#pragma unroll
      for (int i = 0; i < 4; ++i) {
#pragma unroll
        for (int j = 0; j < 4; ++j) {
          acc[i][j] |= (av[i].x & bv[j].x) | (av[i].y & bv[j].y) |
                       (av[i].z & bv[j].z) | (av[i].w & bv[j].w);
        }
      }
    }
    __syncthreads();
  }
}

__global__ void __launch_bounds__(THREADS)
conflict_pair_kernel(const int* __restrict__ foot,
                     const int* __restrict__ write, uint8_t* __restrict__ out,
                     int m, int n, int w) {
  __shared__ __align__(16) Tile s;
  const int row0 = blockIdx.y * TILE, col0 = blockIdx.x * TILE;
  int acc[4][4] = {};
  intersect_tile(foot, write, m, n, w, row0, col0, s, acc);
  const int tx = threadIdx.x % 16, ty = threadIdx.x / 16;
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int r = row0 + ty + 16 * i;
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      const int c = col0 + tx + 16 * j;
      if (r < m && c < n) out[(int64_t)r * n + c] = acc[i][j] != 0;
    }
  }
}

__global__ void __launch_bounds__(THREADS)
conflict_delta_kernel(const int* __restrict__ foot,
                      const int* __restrict__ write,
                      const uint8_t* __restrict__ old,
                      const uint8_t* __restrict__ live,
                      uint8_t* __restrict__ out, int k, int w) {
  __shared__ __align__(16) Tile s;
  const int row0 = blockIdx.y * TILE, col0 = blockIdx.x * TILE;
  const int tx = threadIdx.x % 16, ty = threadIdx.x / 16;
  bool row_live[4], col_live[4];
  bool any = false;
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int r = row0 + ty + 16 * i, c = col0 + tx + 16 * i;
    row_live[i] = r < k && live[r] != 0;
    col_live[i] = c < k && live[c] != 0;
    any = any || row_live[i] || col_live[i];
  }
  int acc[4][4] = {};
  // uniform across the block: either every thread walks W or none does
  if (__syncthreads_or(any)) {
    intersect_tile(foot, write, k, k, w, row0, col0, s, acc);
  }
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int r = row0 + ty + 16 * i;
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      const int c = col0 + tx + 16 * j;
      if (r < k && c < k) {
        const int64_t e = (int64_t)r * k + c;
        out[e] = (row_live[i] || col_live[j]) ? (acc[i][j] != 0) : old[e];
      }
    }
  }
}

}  // namespace

extern "C" int pot_conflict_pair(const int* foot, const int* write,
                                 uint8_t* out, int m, int n, int w,
                                 void* stream) {
  const dim3 grid((n + TILE - 1) / TILE, (m + TILE - 1) / TILE);
  conflict_pair_kernel<<<grid, THREADS, 0, (cudaStream_t)stream>>>(
      foot, write, out, m, n, w);
  return (int)cudaGetLastError();
}

extern "C" int pot_conflict_delta(const int* foot, const int* write,
                                  const uint8_t* old, const uint8_t* live,
                                  uint8_t* out, int k, int w, void* stream) {
  const dim3 grid((k + TILE - 1) / TILE, (k + TILE - 1) / TILE);
  conflict_delta_kernel<<<grid, THREADS, 0, (cudaStream_t)stream>>>(
      foot, write, old, live, out, k, w);
  return (int)cudaGetLastError();
}
