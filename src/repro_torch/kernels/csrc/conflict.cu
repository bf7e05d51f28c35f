// Footprint-conflict tables over bit-packed address sets, for Hopper (sm_90a).
//
//   pair:   out[i, j] = any_w(foot[i, w] & write[j, w])          (M, N)
//   delta:  the same verdict where live[i] | live[j], old[i, j] elsewhere (K, K)
//
// Replaces the two Pallas kernels of repro/kernels/conflict.py:
//   pot_conflict_pair  <- _conflict_kernel        (conflict_matrix_bits_pair)
//   pot_conflict_delta <- _conflict_delta_kernel  (conflict_matrix_bits_delta)
//
// What bounds it on this card.  Every output entry meets W words of its
// footprint row with W words of the write row, M*N*W word pairs, against
// (M + N)*W words of input.  Two instructions can do a word pair:
// LOP3 (acc | (a & b), one pair on one int32 lane) and the binary tensor
// core's mma.sync.m16n8k256.and.popc (16 x 8 x 256 bit pairs, 1,024 word
// pairs, counting popc(a & b) so that an entry conflicts iff its count is
// not 0; the count is at most 32 W, far from int32 overflow).  The H100's
// data sheet gives no binary rate, so chip_smoke.py times a bare loop of
// each on all SMs (rate_probe, below): LOP3 1.66e13-1.67e13 word pairs/s
// (0.99 of the int32 peak), binary MMA 1.60e14-1.61e14, 9.6-9.7 x LOP3
// (H100 80GB HBM3, 700 W).  So this file takes the binary MMA.  At that
// rate the main-path strips (256 x 1024 x 32768) take 0.053 ms of
// operations against 0.050 ms of bytes, so both sides of the roofline
// are close.  What holds the kernels back is staging the operands: a
// bm x bn tile reads 4 (bm + bn) / (bm bn) bytes from L2 per word pair
// (1/16 at 128 x 128), and copies made by the warps take instruction
// slots the MMAs need (PERF.md: the pair at those strips took 0.115 ms
// with cp.async and 0.096 ms once the TMA staged it; larger tiles gained
// little).
//
// What the design does about it:
//  * The card is filled at every shape.  The W axis is cut into S slices
//    and (tile, S) is chosen in Python (kernels/conflict.py, launch_plan)
//    so that tiles x S fills the card's 2 x 132 block slots in one wave.
//    A block writes no entry alone: each thread folds its accumulators
//    into 64-bit masks (one bit an entry), and the slices of one tile OR
//    their masks, exact and order-free, so the table does not depend on
//    block order.  Each block atomicOr's its masks into a small scratch,
//    which the entry point zeroes on the launch stream first, and the
//    last block of the tile to arrive (a counter) writes the table.  (A
//    thread-block cluster combine, S <= 8 slices through distributed
//    shared memory, measured slower than this at the one shape with S <=
//    8 and fits no engine's shape; PERF.md.)  The tile follows M and N,
//    from a menu of the engines' shapes (16 x 8, 16 x 128, 128 x 16,
//    64 x 128, 128 x 64, 128 x 128; ragged shapes round up), so an 8 x 8
//    strip computes a 16 x 8 tile, not a 64 x 64 one.
//  * The tensor cores, not shared memory, are the busy unit.  The 128 x
//    128 tile runs 4 warps of 64 x 64: 32 MMAs per 8 words from 4 + 4
//    ldmatrix.x4, 4 KB of shared memory per 32 K word pairs.
//  * Loads overlap compute: each stage of 32 words (128 bytes a row) of
//    both operands goes into a ring of 3 buffers, one barrier per stage.
//    The pair asks the tensor-memory accelerator for both tiles (one
//    thread, two copies a stage, completing on an mbarrier), which spares
//    the warps the copies' address arithmetic; the delta, whose rows come
//    from lists, and any bitset with W % 4 != 0 or an unaligned base copy
//    their chunks with cp.async (16 or 4 bytes a thread).  Either way a
//    row's 16-byte chunks are XOR-swizzled by the row (the TMA's 128-byte
//    swizzle), so ldmatrix reads 8 rows without a bank conflict, and rows
//    past M or N and words past the slice arrive as zeros; the caller
//    pads nothing.
//  * The delta kernel computes only refreshed entries.  A prep kernel
//    copies old to out and, in its block 0, gathers the live and the
//    settled rows into two device-side lists with their counts (no host
//    sync).  The conflict kernel then computes two strips through those
//    lists: live rows x all K write sets, settled rows x live write sets.
//    Its grid holds the most slices any live count takes; each block
//    reads the count and looks up this call's cut of W in a table that
//    kernels/conflict.py (delta_cuts) makes, and a tile or slice past it
//    returns at once, so the work follows the refreshed entries and
//    still fills the card.
//
// Tables are bool (one byte, 0 or 1).  Each entry point returns
// cudaGetLastError() so the Python wrapper can refuse a failed launch.

#include <cuda.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int CW = 32;            // words of W per stage: 128 bytes a row
constexpr int SCRATCH_STRIDE = 512;  // mask words per tile in the scratch
constexpr int PREP_THREADS = 256;

struct Side {          // one operand: rows of a (rows, w) int32 bitset
  const int* bits;
  const int* list;     // null: tile row r is bits row r; else row list[r]
  const int* count;    // null: n rows; else *count rows (device side)
  int n;
};

struct Job {           // one rectangular strip of the table
  Side a, b;           // a: footprints (table rows), b: write sets (columns)
};

struct Params {
  CUtensorMap map[2];  // tma: the pair's footprints and write sets
  Job job[2];
  uint8_t* out;
  int ld;              // out's row stride
  int w, slice_words;  // slice s covers words [s * slice_words, ...)
  int tiles_m, tiles_n;                // per job
  const int* cuts;     // the delta: (slices, slice_words) per live count
  bool vec;            // 16-byte copies: w % 4 == 0 and aligned bases
  bool tma;            // the pair with vec: both sides staged by the TMA
  unsigned long long* masks;     // slices > 1: [tile][SCRATCH_STRIDE]
  unsigned int* counters;        // slices > 1: [tile]
};

__device__ __forceinline__ int cdiv(int a, int b) { return (a + b - 1) / b; }

__device__ __forceinline__ uint32_t smem_addr(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

__device__ __forceinline__ void cp_async16(uint32_t dst, const void* src,
                                           int bytes) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(dst),
               "l"(src), "r"(bytes));
}

__device__ __forceinline__ void cp_async4(uint32_t dst, const void* src,
                                          int bytes) {
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4, %2;\n" ::"r"(dst),
               "l"(src), "r"(bytes));
}

__device__ __forceinline__ void mbar_init(uint32_t bar) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], 1;\n" ::"r"(bar));
}

__device__ __forceinline__ void mbar_expect(uint32_t bar, int bytes) {
  asm volatile(
      "mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n" ::"r"(bar),
      "r"(bytes)
      : "memory");
}

__device__ __forceinline__ void mbar_wait(uint32_t bar, int parity) {
  asm volatile(
      "{\n"
      ".reg .pred P1;\n"
      "WAIT:\n"
      "mbarrier.try_wait.parity.shared::cta.b64 P1, [%0], %1;\n"
      "@!P1 bra WAIT;\n"
      "}\n" ::"r"(bar),
      "r"(parity)
      : "memory");
}

// rows [y, y + box) x words [x, x + CW) of a map into shared memory at
// dst, 128-byte swizzled (the pattern of swz), completing on bar
__device__ __forceinline__ void tma_load(uint32_t dst, const CUtensorMap* map,
                                         int x, int y, uint32_t bar) {
  asm volatile(
      "cp.async.bulk.tensor.2d.shared::cluster.global.mbarrier::complete_tx"
      "::bytes [%0], [%1, {%2, %3}], [%4];\n" ::"r"(dst),
      "l"(reinterpret_cast<uint64_t>(map)), "r"(x), "r"(y), "r"(bar)
      : "memory");
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::);
}

template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N));
}

__device__ __forceinline__ void ldmatrix_x4(uint32_t addr, uint32_t (&r)[4]) {
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0,%1,%2,%3}, [%4];\n"
      : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
      : "r"(addr));
}

__device__ __forceinline__ void ldmatrix_x2(uint32_t addr, uint32_t& r0,
                                            uint32_t& r1) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x2.shared.b16 {%0,%1}, [%2];\n"
               : "=r"(r0), "=r"(r1)
               : "r"(addr));
}

// acc (16 x 8, s32) += popc(a (16 x 256 bits) & b (256 x 8 bits))
__device__ __forceinline__ void bmma(int (&acc)[4], const uint32_t (&a)[4],
                                     uint32_t b0, uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k256.row.col.s32.b1.b1.s32.and.popc "
      "{%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
      : "+r"(acc[0]), "+r"(acc[1]), "+r"(acc[2]), "+r"(acc[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// Byte offset of (row, 16-byte chunk) in a stage: rows of 128 bytes, the
// chunk XOR-swizzled by the row so 8 consecutive rows hit 8 bank groups.
__device__ __forceinline__ uint32_t swz(int row, int chunk) {
  return row * (CW * 4) + ((chunk ^ (row & 7)) << 4);
}

// The conflict kernel.  Block tile BM x BN = (16 FM WM) x (8 FN WN): WM x
// WN warps, each FM x FN MMA tiles of 16 x 8; a ring of ST stages; at
// least MINB blocks an SM.  grid.x = slices of W, grid.y = jobs x
// tiles_m x tiles_n.
template <int WM, int WN, int FM, int FN, int ST, int MINB>
__global__ void __launch_bounds__(32 * WM * WN, MINB)
conflict_kernel(const __grid_constant__ Params p) {
  constexpr int THREADS = 32 * WM * WN;
  constexpr int BM = 16 * FM * WM, BN = 8 * FN * WN;
  constexpr int ROWS = BM + BN;             // staged rows: a's, then b's
  constexpr int CHUNKS = ROWS * CW / 4;     // 16-byte chunks a stage
  constexpr int LOADS = (CHUNKS + THREADS - 1) / THREADS;
  constexpr int STAGE_BYTES = ROWS * CW * 4;
  constexpr int MW = (FM * FN * 4 + 63) / 64;   // mask words a thread
  static_assert(FN == 1 || FN % 2 == 0, "B fragments load in pairs");
  static_assert(THREADS * MW <= SCRATCH_STRIDE, "scratch stride");
  extern __shared__ __align__(1024) uint8_t smem[];
  __shared__ __align__(8) unsigned long long bars[ST];   // tma: one a stage
  __shared__ bool last;

  const int tiles = p.tiles_m * p.tiles_n;
  const int tile = blockIdx.y;
  const bool second = tile >= tiles;
  const int t = second ? tile - tiles : tile;
  const int* a_bits = second ? p.job[1].a.bits : p.job[0].a.bits;
  const int* a_list = second ? p.job[1].a.list : p.job[0].a.list;
  const int* a_count = second ? p.job[1].a.count : p.job[0].a.count;
  const int* b_bits = second ? p.job[1].b.bits : p.job[0].b.bits;
  const int* b_list = second ? p.job[1].b.list : p.job[0].b.list;
  const int* b_count = second ? p.job[1].b.count : p.job[0].b.count;
  const int m = a_count ? *a_count : (second ? p.job[1].a.n : p.job[0].a.n);
  const int n = b_count ? *b_count : (second ? p.job[1].b.n : p.job[0].b.n);
  const int row0 = (t / p.tiles_n) * BM, col0 = (t % p.tiles_n) * BN;
  if (row0 >= m || col0 >= n) return;   // uniform over the block

  int slices = gridDim.x, slice_words = p.slice_words;
  if (p.cuts) {
    // the delta: this call's live count picks the cut of W
    const int* cut = p.cuts + 2 * *p.job[0].a.count;
    slices = cut[0];
    slice_words = cut[1];
    if ((int)blockIdx.x >= slices) return;
  }

  const int w_lo = blockIdx.x * slice_words;
  const int w_hi = min(p.w, w_lo + slice_words);
  const int n_stages = w_hi > w_lo ? cdiv(w_hi - w_lo, CW) : 0;
  const int tid = threadIdx.x;

  // this thread's chunks of a stage: chunk e = tid + i THREADS is row
  // e / 8, 16-byte chunk e % 8 (= tid % 8: THREADS is a multiple of 8);
  // row[i] is that row's index in its bitset, -1 past M or N
  const int c = tid % (CW / 4);
  int row[LOADS];
#pragma unroll
  for (int i = 0; i < LOADS; ++i) {
    const int e = tid + i * THREADS, r = e / (CW / 4);
    const bool is_a = r < BM;
    const int tr = is_a ? row0 + r : col0 + r - BM;
    const int* list = is_a ? a_list : b_list;
    row[i] = e < CHUNKS && tr < (is_a ? m : n) ? (list ? list[tr] : tr) : -1;
  }
  // stage buffers on 1024-byte boundaries: the TMA's 128-byte swizzle
  // repeats every 8 rows of 128 bytes (the launch adds 1 KB for this)
  const uint32_t base = (smem_addr(smem) + 1023) & ~1023u;
  const uint32_t bar0 = smem_addr(bars);
  if (p.tma) {
    if (tid == 0) {
#pragma unroll
      for (int s = 0; s < ST; ++s) mbar_init(bar0 + 8 * s);
      asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
    }
    __syncthreads();
  }

  // stage words [k0, k0 + CW) of the slice into buffer BUF: one thread
  // asks the TMA for both tiles (zero past M, N or W), or every thread
  // copies its chunks
#define POT_LOAD_STAGE(BUF, KT)                                            \
  {                                                                        \
    const int k0 = w_lo + (KT) * CW;                                       \
    const int left = w_hi - (k0 + 4 * c); /* words of the slice here */    \
    const uint32_t sb = base + (BUF) * STAGE_BYTES;                        \
    if (p.tma) {                                                           \
      if (tid == 0) {                                                      \
        const uint32_t bar = bar0 + 8 * (BUF);                             \
        mbar_expect(bar, STAGE_BYTES);                                     \
        tma_load(sb, &p.map[0], k0, row0, bar);                            \
        tma_load(sb + BM * CW * 4, &p.map[1], k0, col0, bar);              \
      }                                                                    \
    } else {                                                               \
      _Pragma("unroll") for (int i = 0; i < LOADS; ++i) {                  \
        const int e = tid + i * THREADS;                                   \
        if (CHUNKS % THREADS != 0 && e >= CHUNKS) continue;                \
        const uint32_t d = sb + swz(e / (CW / 4), c);                      \
        const int* g = (e / (CW / 4) < BM ? a_bits : b_bits) +             \
                       (int64_t)max(row[i], 0) * p.w + k0 + 4 * c;         \
        if (p.vec) {                                                       \
          const bool ok = row[i] >= 0 && left > 0;                         \
          cp_async16(d, ok ? g : a_bits, ok ? 16 : 0);                     \
        } else {                                                           \
          _Pragma("unroll") for (int j = 0; j < 4; ++j) {                  \
            const bool ok = row[i] >= 0 && left > j;                       \
            cp_async4(d + 4 * j, ok ? g + j : a_bits, ok ? 4 : 0);         \
          }                                                                \
        }                                                                  \
      }                                                                    \
    }                                                                      \
  }

  const int warp = tid / 32, lane = tid % 32;
  const int wm = warp / WN, wn = warp % WN;
  int acc[FM][FN][4];
#pragma unroll
  for (int i = 0; i < FM; ++i)
#pragma unroll
    for (int j = 0; j < FN; ++j)
#pragma unroll
      for (int q = 0; q < 4; ++q) acc[i][j][q] = 0;

#pragma unroll
  for (int s = 0; s < ST - 1; ++s) {
    if (s < n_stages) POT_LOAD_STAGE(s, s)
    cp_async_commit();
  }
  for (int kt = 0; kt < n_stages; ++kt) {
    if (p.tma) mbar_wait(bar0 + 8 * (kt % ST), (kt / ST) & 1);
    else cp_async_wait<ST - 2>();
    __syncthreads();
    const int nxt = kt + ST - 1;
    if (nxt < n_stages) POT_LOAD_STAGE(nxt % ST, nxt)
    cp_async_commit();
    const uint32_t sb = base + (kt % ST) * STAGE_BYTES;
#pragma unroll
    for (int ks = 0; ks < CW / 8; ++ks) {   // 8 words = 256 bits a step
      uint32_t af[FM][4], bf[FN][2];
#pragma unroll
      for (int i = 0; i < FM; ++i) {
        // matrices: rows 0-7 / 8-15 of words 0-3, then of words 4-7
        const int r = wm * FM * 16 + i * 16 + (lane & 15);
        ldmatrix_x4(sb + swz(r, 2 * ks + (lane >> 4)), af[i]);
      }
      if constexpr (FN == 1) {
        const int r = BM + wn * 8 + (lane & 7);
        ldmatrix_x2(sb + swz(r, 2 * ks + ((lane >> 3) & 1)), bf[0][0],
                    bf[0][1]);
      } else {
#pragma unroll
        for (int j = 0; j < FN; j += 2) {
          // matrices: columns j (words 0-3, 4-7), columns j + 1 (same)
          const int r = BM + wn * FN * 8 + j * 8 + (lane & 7) +
                        ((lane >> 4) << 3);
          uint32_t v[4];
          ldmatrix_x4(sb + swz(r, 2 * ks + ((lane >> 3) & 1)), v);
          bf[j][0] = v[0];
          bf[j][1] = v[1];
          bf[j + 1][0] = v[2];
          bf[j + 1][1] = v[3];
        }
      }
#pragma unroll
      for (int i = 0; i < FM; ++i)
#pragma unroll
        for (int j = 0; j < FN; ++j) bmma(acc[i][j], af[i], bf[j][0], bf[j][1]);
    }
  }
#undef POT_LOAD_STAGE
  cp_async_wait<0>();

  // one bit an entry: (i, j, q) -> bit (i FN + j) 4 + q of the masks; the
  // entry's row is 16 i + lane / 4 (+ 8 for q >= 2), its column 8 j +
  // 2 (lane % 4) + q % 2, both inside the warp's tile
  unsigned long long mask[MW];
#pragma unroll
  for (int v = 0; v < MW; ++v) mask[v] = 0;
#pragma unroll
  for (int i = 0; i < FM; ++i)
#pragma unroll
    for (int j = 0; j < FN; ++j)
#pragma unroll
      for (int q = 0; q < 4; ++q) {
        const int bit = (i * FN + j) * 4 + q;
        if (acc[i][j][q] != 0) mask[bit / 64] |= 1ull << (bit % 64);
      }

  if (slices > 1) {   // the scratch combine: the tile's last block writes
    unsigned long long* slot = p.masks + (int64_t)tile * SCRATCH_STRIDE + tid;
#pragma unroll
    for (int v = 0; v < MW; ++v)
      if (mask[v]) atomicOr(slot + v * THREADS, mask[v]);
    __threadfence();
    __syncthreads();
    if (tid == 0)
      last = atomicAdd(p.counters + tile, 1u) == (unsigned)slices - 1;
    __syncthreads();
    if (!last) return;
    __threadfence();
#pragma unroll
    for (int v = 0; v < MW; ++v) mask[v] = __ldcg(slot + v * THREADS);
  }

  const int g = lane >> 2, tq = lane & 3;
#pragma unroll
  for (int i = 0; i < FM; ++i)
#pragma unroll
    for (int q2 = 0; q2 < 2; ++q2) {
      const int r = row0 + wm * FM * 16 + i * 16 + g + 8 * q2;
      if (r >= m) continue;
      uint8_t* orow = p.out + (int64_t)(a_list ? a_list[r] : r) * p.ld;
#pragma unroll
      for (int j = 0; j < FN; ++j)
#pragma unroll
        for (int q1 = 0; q1 < 2; ++q1) {
          const int col = col0 + wn * FN * 8 + j * 8 + 2 * tq + q1;
          if (col >= n) continue;
          const int bit = (i * FN + j) * 4 + 2 * q2 + q1;
          orow[b_list ? b_list[col] : col] = (mask[bit / 64] >> (bit % 64)) & 1;
        }
    }
}

// The delta's prep: every block copies its share of old to out; block 0
// then lists the live rows (lists[0 .. n_live)) and the settled ones
// (lists[k .. k + n_dead)), ascending, with n_live at lists[2k] and n_dead
// at lists[2k + 1].
__global__ void __launch_bounds__(PREP_THREADS)
delta_prep_kernel(const uint8_t* __restrict__ old,
                  const uint8_t* __restrict__ live, uint8_t* __restrict__ out,
                  int* __restrict__ lists, int k, bool vec) {
  const int64_t total = (int64_t)k * k;
  const int64_t stride = (int64_t)gridDim.x * PREP_THREADS;
  const int64_t first = (int64_t)blockIdx.x * PREP_THREADS + threadIdx.x;
  if (vec) {
    const int64_t n16 = total / 16;
    for (int64_t i = first; i < n16; i += stride)
      reinterpret_cast<uint4*>(out)[i] = reinterpret_cast<const uint4*>(old)[i];
    for (int64_t i = n16 * 16 + first; i < total; i += stride) out[i] = old[i];
  } else {
    for (int64_t i = first; i < total; i += stride) out[i] = old[i];
  }
  if (blockIdx.x != 0) return;

  __shared__ int warp_live[PREP_THREADS / 32];
  __shared__ int base_live;
  const int lane = threadIdx.x % 32, warp = threadIdx.x / 32;
  if (threadIdx.x == 0) base_live = 0;
  __syncthreads();
  for (int c0 = 0; c0 < k; c0 += PREP_THREADS) {
    const int i = c0 + threadIdx.x;
    const bool is_live = i < k && live[i] != 0;
    const unsigned ballot = __ballot_sync(0xffffffffu, is_live);
    if (lane == 0) warp_live[warp] = __popc(ballot);
    __syncthreads();
    int before = base_live;   // live rows before this thread's
    int chunk_live = 0;
    for (int v = 0; v < PREP_THREADS / 32; ++v) {
      if (v < warp) before += warp_live[v];
      chunk_live += warp_live[v];
    }
    before += __popc(ballot & ((1u << lane) - 1));
    if (i < k) {
      if (is_live) lists[before] = i;
      else lists[k + i - before] = i;   // settled rows before i: i - before
    }
    __syncthreads();
    if (threadIdx.x == 0) base_live += chunk_live;
    __syncthreads();
  }
  if (threadIdx.x == 0) {
    lists[2 * k] = base_live;
    lists[2 * k + 1] = k - base_live;
  }
}

template <int WM, int WN, int FM, int FN, int ST, int MINB>
cudaError_t launch_tile(const Params& p, int slices, int jobs,
                        cudaStream_t stream) {
  constexpr int THREADS = 32 * WM * WN;
  constexpr int SMEM = ST * (16 * FM * WM + 8 * FN * WN) * CW * 4 + 1024;
  auto kernel = conflict_kernel<WM, WN, FM, FN, ST, MINB>;
  cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, SMEM);
  if (err != cudaSuccess) return err;
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(slices, jobs * p.tiles_m * p.tiles_n, 1);
  cfg.blockDim = dim3(THREADS, 1, 1);
  cfg.dynamicSmemBytes = SMEM;
  cfg.stream = stream;
  return cudaLaunchKernelEx(&cfg, kernel, p);
}

// The tile menu of kernels/conflict.py (TILES); two blocks of each fit an
// SM (BLOCKS).
cudaError_t launch(Params& p, int bm, int bn, int slices, int jobs,
                   cudaStream_t stream) {
  switch (bm * 1000 + bn) {
    case 16008: return launch_tile<1, 1, 1, 1, 3, 16>(p, slices, jobs, stream);
    case 16128: return launch_tile<1, 8, 1, 2, 3, 2>(p, slices, jobs, stream);
    case 128016: return launch_tile<8, 1, 1, 2, 3, 2>(p, slices, jobs, stream);
    case 64128: return launch_tile<2, 4, 2, 4, 3, 2>(p, slices, jobs, stream);
    case 128064: return launch_tile<4, 2, 2, 4, 3, 2>(p, slices, jobs, stream);
    case 128128: return launch_tile<2, 2, 4, 8, 3, 2>(p, slices, jobs, stream);
  }
  return cudaErrorInvalidValue;
}

bool aligned16(const void* ptr) {
  return (reinterpret_cast<uintptr_t>(ptr) & 15) == 0;
}

typedef CUresult (*EncodeTiled)(CUtensorMap*, CUtensorMapDataType, cuuint32_t,
                                void*, const cuuint64_t*, const cuuint64_t*,
                                const cuuint32_t*, const cuuint32_t*,
                                CUtensorMapInterleave, CUtensorMapSwizzle,
                                CUtensorMapL2promotion,
                                CUtensorMapFloatOOBfill);

// The TMA's map of a (rows, w) int32 bitset (w % 4 == 0, aligned base) in
// boxes of `box` rows x CW words, 128-byte swizzled, zero past either
// edge.  cuTensorMapEncodeTiled is found with cudaGetDriverEntryPoint,
// so nothing links against libcuda.
cudaError_t tensor_map(CUtensorMap* map, const int* bits, int rows, int w,
                       int box) {
  static EncodeTiled encode = nullptr;
  if (!encode) {
    cudaDriverEntryPointQueryResult found;
    cudaError_t err = cudaGetDriverEntryPoint(
        "cuTensorMapEncodeTiled", reinterpret_cast<void**>(&encode),
        cudaEnableDefault, &found);
    if (err != cudaSuccess) return err;
    if (found != cudaDriverEntryPointSuccess) return cudaErrorNotSupported;
  }
  const cuuint64_t dims[2] = {(cuuint64_t)w, (cuuint64_t)rows};
  const cuuint64_t strides[1] = {(cuuint64_t)w * 4};
  const cuuint32_t boxes[2] = {(cuuint32_t)CW, (cuuint32_t)box};
  const cuuint32_t unit[2] = {1, 1};
  const CUresult res = encode(
      map, CU_TENSOR_MAP_DATA_TYPE_INT32, 2, const_cast<int*>(bits), dims,
      strides, boxes, unit, CU_TENSOR_MAP_INTERLEAVE_NONE,
      CU_TENSOR_MAP_SWIZZLE_128B, CU_TENSOR_MAP_L2_PROMOTION_L2_256B,
      CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE);
  return res == CUDA_SUCCESS ? cudaSuccess : cudaErrorInvalidValue;
}

// The scratch combine's scratch, for slices > 1: [tiles][SCRATCH_STRIDE]
// masks, then [tiles] counters, zeroed on the launch's stream.
cudaError_t place_scratch(Params& p, unsigned long long* scratch, int tiles,
                          int slices, cudaStream_t stream) {
  p.masks = scratch;
  p.counters = reinterpret_cast<unsigned int*>(
      p.masks + (int64_t)tiles * SCRATCH_STRIDE);
  if (slices == 1) return cudaSuccess;
  return cudaMemsetAsync(scratch, 0,
                         (size_t)tiles * (SCRATCH_STRIDE + 1) * 8, stream);
}

// ---- instruction-rate probes: the route choice rests on these ---------
// Each thread (LOP3) or warp (binary MMA) runs independent chains of one
// instruction on register operands; the caller times the launch and
// divides the word pairs by the time.  The result is stored only when
// an impossible value comes out, so nothing is optimised away.

__global__ void __launch_bounds__(256)
rate_lop3_kernel(int* __restrict__ sink, int iters, int seed) {
  int a[8], b[8], acc[8][8];
#pragma unroll
  for (int i = 0; i < 8; ++i) {
    a[i] = seed * (int)(threadIdx.x + 8 * i + 1);
    b[i] = seed ^ (int)(blockIdx.x * 8 + i);
  }
#pragma unroll
  for (int i = 0; i < 8; ++i)
#pragma unroll
    for (int j = 0; j < 8; ++j) acc[i][j] = 0;
  for (int it = 0; it < iters; ++it) {
#pragma unroll
    for (int i = 0; i < 8; ++i)
#pragma unroll
      for (int j = 0; j < 8; ++j)
        asm volatile("lop3.b32 %0, %1, %2, %0, 0xEA;"   // acc | (a & b)
                     : "+r"(acc[i][j]) : "r"(a[i]), "r"(b[j]));
  }
  int r = 0;
#pragma unroll
  for (int i = 0; i < 8; ++i)
#pragma unroll
    for (int j = 0; j < 8; ++j) r ^= acc[i][j];
  if (r == 0x5a5a5a5a) sink[blockIdx.x] = r;
}

__global__ void __launch_bounds__(256)
rate_bmma_kernel(int* __restrict__ sink, int iters, int seed) {
  uint32_t a[4], b[2];
  int acc[4][4];
#pragma unroll
  for (int i = 0; i < 4; ++i) a[i] = seed * (threadIdx.x + i + 1);
  b[0] = seed ^ blockIdx.x;
  b[1] = ~b[0];
#pragma unroll
  for (int q = 0; q < 4; ++q)
#pragma unroll
    for (int i = 0; i < 4; ++i) acc[q][i] = 0;
  for (int it = 0; it < iters; ++it) {
#pragma unroll
    for (int q = 0; q < 4; ++q) bmma(acc[q], a, b[0], b[1]);
  }
  int r = 0;
#pragma unroll
  for (int q = 0; q < 4; ++q)
#pragma unroll
    for (int i = 0; i < 4; ++i) r ^= acc[q][i];
  if (r == 0x5a5a5a5a) sink[blockIdx.x] = r;
}

}  // namespace

// Pair: one job.  `bm` x `bn` names the tile and `slices` x
// `slice_words` the cut of W (launch_plan in kernels/conflict.py);
// `scratch` holds tiles x (SCRATCH_STRIDE + 1) words where slices > 1.
extern "C" int pot_conflict_pair(const int* foot, const int* write,
                                 uint8_t* out, unsigned long long* scratch,
                                 int m, int n, int w, int bm, int bn,
                                 int slices, int slice_words, void* stream) {
  cudaStream_t st = (cudaStream_t)stream;
  Params p = {};
  p.job[0].a = Side{foot, nullptr, nullptr, m};
  p.job[0].b = Side{write, nullptr, nullptr, n};
  p.job[1] = p.job[0];
  p.out = out;
  p.ld = n;
  p.w = w;
  p.slice_words = slice_words;
  p.tiles_m = (m + bm - 1) / bm;
  p.tiles_n = (n + bn - 1) / bn;
  p.vec = w % 4 == 0 && aligned16(foot) && aligned16(write);
  p.tma = p.vec && w > 0;
  cudaError_t err = place_scratch(p, scratch, p.tiles_m * p.tiles_n, slices, st);
  if (p.tma && err == cudaSuccess) err = tensor_map(&p.map[0], foot, m, w, bm);
  if (p.tma && err == cudaSuccess) err = tensor_map(&p.map[1], write, n, w, bn);
  if (err != cudaSuccess) return (int)err;
  err = launch(p, bm, bn, slices, 1, st);
  if (err != cudaSuccess) return (int)err;
  return (int)cudaGetLastError();
}

// Delta: the prep kernel, then two jobs over its lists (live rows x all
// columns, settled rows x live columns), each tiled as a K x K strip.
// The grid holds `slices` slices, the most any live count takes; `cuts`
// holds (slices, slice_words) for each live count 0 .. k (delta_plan and
// delta_cuts in kernels/conflict.py).  `lists` holds 2 k + 2 ints;
// `scratch` 2 x tiles x (SCRATCH_STRIDE + 1) words where slices > 1.
extern "C" int pot_conflict_delta(const int* foot, const int* write,
                                  const uint8_t* old, const uint8_t* live,
                                  uint8_t* out, int* lists,
                                  unsigned long long* scratch,
                                  const int* cuts, int k, int w, int bm,
                                  int bn, int slices, void* stream) {
  cudaStream_t st = (cudaStream_t)stream;
  const int64_t total = (int64_t)k * k;
  const int64_t want = (total / 16 + PREP_THREADS - 1) / PREP_THREADS + 1;
  const int prep_blocks = (int)(want < 264 ? want : 264);
  delta_prep_kernel<<<prep_blocks, PREP_THREADS, 0, st>>>(
      old, live, out, lists, k, aligned16(old) && aligned16(out));
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  const int* n_live = lists + 2 * k;
  const int* n_dead = lists + 2 * k + 1;
  Params p = {};
  p.job[0].a = Side{foot, lists, n_live, k};
  p.job[0].b = Side{write, nullptr, nullptr, k};
  p.job[1].a = Side{foot, lists + k, n_dead, k};
  p.job[1].b = Side{write, lists, n_live, k};
  p.out = out;
  p.ld = k;
  p.w = w;
  p.tiles_m = (k + bm - 1) / bm;
  p.tiles_n = (k + bn - 1) / bn;
  p.cuts = cuts;
  p.vec = w % 4 == 0 && aligned16(foot) && aligned16(write);
  err = place_scratch(p, scratch, 2 * p.tiles_m * p.tiles_n, slices, st);
  if (err != cudaSuccess) return (int)err;
  err = launch(p, bm, bn, slices, 2, st);
  if (err != cudaSuccess) return (int)err;
  return (int)cudaGetLastError();
}

// Probes: `blocks` blocks of 256 threads, `iters` trips each.  LOP3:
// 64 word pairs per thread per trip; binary MMA: 4 m16n8k256 per warp
// per trip, 16 x 8 x 8 = 1024 word pairs each.
extern "C" int pot_rate_lop3(int* sink, int blocks, int iters, int seed,
                             void* stream) {
  rate_lop3_kernel<<<blocks, 256, 0, (cudaStream_t)stream>>>(sink, iters,
                                                               seed);
  return (int)cudaGetLastError();
}

extern "C" int pot_rate_bmma(int* sink, int blocks, int iters, int seed,
                             void* stream) {
  rate_bmma_kernel<<<blocks, 256, 0, (cudaStream_t)stream>>>(sink, iters,
                                                               seed);
  return (int)cudaGetLastError();
}
