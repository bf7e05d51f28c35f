// TL2 read-set validation over bit-packed address sets, for Hopper (sm_90a).
//
//   out[k] = any_w(read[k, w] & written[w])          read (K, W), written (W,)
//
// Replaces the Pallas kernel of repro/kernels/validate.py:
//   pot_validate  <- _validate_kernel  (validate_bitsets)
//
// What bounds it on this card: bytes.  Every read word is used once, in one
// AND and one OR (one LOP3), so the work is K*W operations against K*W*4
// bytes of read sets; at the shapes of the engines' stores (K = 1024 rows,
// W = 32768 words) the 134 MB take 0.040 ms at 3.35 TB/s and the 33.5 M
// LOP3s 0.002 ms at the int32 rate.
//
// What the design does about it: each block of 256 threads owns ROWS = 4
// rows and walks the W axis with the threads side by side, so a warp reads
// 32 consecutive vectors of one row (512 bytes with int4 loads).  A thread
// loads a vector of `written` once and ANDs it with the same vector of each
// of its block's rows, so `written` crosses L2 once per four rows.  The
// loop is unrolled so that each thread keeps several loads in flight.  The
// rows' OR-accumulators are reduced across the block with
// __syncthreads_or, and one thread writes each row's byte.  Nothing exits
// early, so the time does not depend on the data, and nothing is atomic.
//
// int4 loads need every row and `written` 16-byte aligned: W % 4 == 0 and
// both base pointers aligned.  Any other shape or view (a ragged W, an
// unaligned view) runs the same loop over single words.  Ragged K is
// masked (a block's rows past K load nothing and write nothing), so the
// caller pads nothing.  The entry point returns cudaGetLastError() so the
// Python wrapper can refuse a failed launch.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int ROWS = 4;       // rows per block, sharing each written vector
constexpr int THREADS = 256;

__device__ __forceinline__ int and_any(int a, int b) { return a & b; }
__device__ __forceinline__ int and_any(int4 a, int4 b) {
  return (a.x & b.x) | (a.y & b.y) | (a.z & b.z) | (a.w & b.w);
}

// V is int4 (n = W / 4 vectors a row) or int (n = W words a row)
template <typename V>
__global__ void __launch_bounds__(THREADS)
validate_kernel(const V* __restrict__ read, const V* __restrict__ written,
                uint8_t* __restrict__ out, int k, int64_t n) {
  const int row0 = blockIdx.x * ROWS;
  const V* rows[ROWS];
  bool in[ROWS];
#pragma unroll
  for (int i = 0; i < ROWS; ++i) {
    in[i] = row0 + i < k;
    rows[i] = read + (int64_t)(in[i] ? row0 + i : 0) * n;
  }
  int acc[ROWS] = {};
#pragma unroll 4
  for (int64_t c = threadIdx.x; c < n; c += THREADS) {
    const V wv = written[c];
#pragma unroll
    for (int i = 0; i < ROWS; ++i) {
      if (in[i]) acc[i] |= and_any(rows[i][c], wv);
    }
  }
#pragma unroll
  for (int i = 0; i < ROWS; ++i) {
    // uniform across the block: every thread reaches every barrier
    const int hit = __syncthreads_or(acc[i] != 0);
    if (threadIdx.x == 0 && in[i]) out[row0 + i] = hit != 0;
  }
}

}  // namespace

extern "C" int pot_validate(const int* read, const int* written, uint8_t* out,
                            int k, int w, void* stream) {
  const dim3 grid((k + ROWS - 1) / ROWS);
  const cudaStream_t s = (cudaStream_t)stream;
  const bool vec = w % 4 == 0 && (uintptr_t)read % 16 == 0 &&
                   (uintptr_t)written % 16 == 0;
  if (vec) {
    validate_kernel<int4><<<grid, THREADS, 0, s>>>(
        reinterpret_cast<const int4*>(read),
        reinterpret_cast<const int4*>(written), out, k, w / 4);
  } else {
    validate_kernel<int><<<grid, THREADS, 0, s>>>(read, written, out, k, w);
  }
  return (int)cudaGetLastError();
}
