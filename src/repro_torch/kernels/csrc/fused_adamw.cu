// Fused AdamW: the fast-mode direct commit of a gradient into (p, m, v),
// and its speculative variant under TL2 block-version validation, for
// Hopper (sm_90a).
//
// With hp = [lr, b1, b2, eps, wd, bc1, bc2, rv] (a float32 device vector),
// for every element, in this order and rounding after every operation:
//   m' = b1*m + (1-b1)*g
//   v' = b2*v + ((1-b2)*g)*g
//   p' = p - lr*((m'/bc1) / (sqrt(v'/bc2) + eps) + wd*p)
// g is read as float32 or bfloat16 (converted exactly); p, m, v are float32.
// The speculative variant works on a (R, C) matrix cut into 256 x 256
// blocks, each with one int32 version: a block whose version, converted to
// float32, exceeds rv is stale.  A stale block's p, m and v are copied
// through unchanged and its abort word is 1; any other block is updated and
// its abort word is 0.
//
// Replaces the Pallas kernels of repro/kernels/fused_adamw.py:
//   pot_adamw_f32g / pot_adamw_bf16g <- _adamw_kernel (fused_adamw)
//   pot_adamw_spec                   <- _adamw_spec_kernel
//                                       (fused_adamw_speculative)
//
// Rounding: every operation is an explicit round-to-nearest intrinsic
// (__fmul_rn, __fadd_rn, __fdiv_rn, __fsqrt_rn), which nvcc never contracts
// into a fused multiply-add, so the kernel gives the bits of the plain
// PyTorch version (one rounded operation per torch op) whatever the
// compiler flags.  (1-b1) and (1-b2) are float32 differences of the float32
// hyperparameters, as in the Pallas kernel.
//
// What bounds it on this card: bytes.  Each element reads p, m, v and g
// (16 bytes, 14 with bfloat16 g) and writes p', m', v' (12 bytes) for about
// 20 floating-point operations: 0.7 operations per byte, far below the
// H100's float32 ratio of 20 (67 TFLOP/s over 3.35 TB/s).  A stale block of
// the speculative variant needs no g: 24 bytes per element.
//
// What the design does about it: one pass, every byte moved once, in
// 16-byte vector accesses (float4; 8 bytes for four bfloat16 g), with
// neighbouring threads on neighbouring vectors.  The elementwise kernel is a
// grid-stride loop with 64-bit indices (a leaf may hold more than 2^31
// bytes) and a scalar tail; where a pointer is not 16-byte aligned (a view
// into another tensor) the same loop runs on single elements.  The
// speculative kernel gives each 256 x 256 block to one CUDA block, so the
// block reads its version once and either copies or updates; there is no
// dependence on block order and no atomics.
//
// Each entry point returns cudaGetLastError() so the Python wrapper can
// refuse a failed launch.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int THREADS = 256;
constexpr int MAX_BLOCKS = 132 * 8;  // 2048 threads on each of the 132 SMs
constexpr int BLOCK = 256;           // rows and columns of a version block

struct Hp {
  float lr, b1, b2, eps, wd, bc1, bc2, rv;
};

__device__ __forceinline__ Hp load_hp(const float* hp) {
  return Hp{hp[0], hp[1], hp[2], hp[3], hp[4], hp[5], hp[6], hp[7]};
}

__device__ __forceinline__ void adamw(const Hp& h, float p, float m, float v,
                                      float g, float& po, float& mo,
                                      float& vo) {
  const float mn = __fadd_rn(__fmul_rn(h.b1, m),
                             __fmul_rn(__fsub_rn(1.0f, h.b1), g));
  const float vn = __fadd_rn(__fmul_rn(h.b2, v),
                             __fmul_rn(__fmul_rn(__fsub_rn(1.0f, h.b2), g), g));
  const float mhat = __fdiv_rn(mn, h.bc1);
  const float vhat = __fdiv_rn(vn, h.bc2);
  const float den = __fadd_rn(__fsqrt_rn(vhat), h.eps);
  const float upd = __fadd_rn(__fdiv_rn(mhat, den), __fmul_rn(h.wd, p));
  po = __fsub_rn(p, __fmul_rn(h.lr, upd));
  mo = mn;
  vo = vn;
}

__device__ __forceinline__ float to_float(float x) { return x; }
__device__ __forceinline__ float to_float(__nv_bfloat16 x) {
  return __bfloat162float(x);
}

// four consecutive gradient values from a 16-byte (float) or 8-byte
// (bfloat16) aligned address
__device__ __forceinline__ float4 load4(const float* g) {
  return *reinterpret_cast<const float4*>(g);
}
__device__ __forceinline__ float4 load4(const __nv_bfloat16* g) {
  const uint2 raw = *reinterpret_cast<const uint2*>(g);
  const __nv_bfloat162 lo = *reinterpret_cast<const __nv_bfloat162*>(&raw.x);
  const __nv_bfloat162 hi = *reinterpret_cast<const __nv_bfloat162*>(&raw.y);
  return make_float4(__low2float(lo), __high2float(lo), __low2float(hi),
                     __high2float(hi));
}

__device__ __forceinline__ void adamw4(const Hp& h, int64_t i,
                                       const float* __restrict__ p,
                                       const float* __restrict__ m,
                                       const float* __restrict__ v, float4 g,
                                       float* __restrict__ po,
                                       float* __restrict__ mo,
                                       float* __restrict__ vo) {
  const float4 p4 = *reinterpret_cast<const float4*>(p + i);
  const float4 m4 = *reinterpret_cast<const float4*>(m + i);
  const float4 v4 = *reinterpret_cast<const float4*>(v + i);
  float4 pn, mn, vn;
  adamw(h, p4.x, m4.x, v4.x, g.x, pn.x, mn.x, vn.x);
  adamw(h, p4.y, m4.y, v4.y, g.y, pn.y, mn.y, vn.y);
  adamw(h, p4.z, m4.z, v4.z, g.z, pn.z, mn.z, vn.z);
  adamw(h, p4.w, m4.w, v4.w, g.w, pn.w, mn.w, vn.w);
  *reinterpret_cast<float4*>(po + i) = pn;
  *reinterpret_cast<float4*>(mo + i) = mn;
  *reinterpret_cast<float4*>(vo + i) = vn;
}

// VEC: every pointer is aligned for vector access; then the first
// 4*(n/4) elements go four at a time and the tail one at a time.
template <typename G, bool VEC>
__global__ void __launch_bounds__(THREADS)
adamw_kernel(const float* __restrict__ hp, const float* __restrict__ p,
             const float* __restrict__ m, const float* __restrict__ v,
             const G* __restrict__ g, float* __restrict__ po,
             float* __restrict__ mo, float* __restrict__ vo, int64_t n) {
  const Hp h = load_hp(hp);
  const int64_t tid = (int64_t)blockIdx.x * THREADS + threadIdx.x;
  const int64_t stride = (int64_t)gridDim.x * THREADS;
  int64_t head = 0;
  if (VEC) {
    head = n / 4 * 4;
    for (int64_t i = tid * 4; i < head; i += stride * 4)
      adamw4(h, i, p, m, v, load4(g + i), po, mo, vo);
  }
  for (int64_t i = head + tid; i < n; i += stride)
    adamw(h, p[i], m[i], v[i], to_float(g[i]), po[i], mo[i], vo[i]);
}

// One CUDA block per 256 x 256 version block of a (rows, cols) matrix,
// cols a multiple of 256; blockIdx.x = block row * (cols / 256) + block col.
template <bool VEC>
__global__ void __launch_bounds__(THREADS)
adamw_spec_kernel(const float* __restrict__ hp,
                  const int* __restrict__ versions,
                  const float* __restrict__ p, const float* __restrict__ m,
                  const float* __restrict__ v, const float* __restrict__ g,
                  float* __restrict__ po, float* __restrict__ mo,
                  float* __restrict__ vo, int* __restrict__ abort_out,
                  int64_t cols) {
  const Hp h = load_hp(hp);
  const int64_t gc = cols / BLOCK;
  const int64_t bi = blockIdx.x / gc, bj = blockIdx.x % gc;
  // int32 -> float32 rounds to nearest, as astype(float32) does
  const bool stale = __int2float_rn(versions[blockIdx.x]) > h.rv;
  if (threadIdx.x == 0) abort_out[blockIdx.x] = stale ? 1 : 0;
  const int64_t base = bi * BLOCK * cols + bj * BLOCK;
  constexpr int W = VEC ? 4 : 1;  // elements per access
  for (int k = threadIdx.x; k < BLOCK * BLOCK / W; k += THREADS) {
    const int64_t i = base + (int64_t)(k / (BLOCK / W)) * cols +
                      (k % (BLOCK / W)) * W;
    if (VEC) {
      if (stale) {
        *reinterpret_cast<float4*>(po + i) =
            *reinterpret_cast<const float4*>(p + i);
        *reinterpret_cast<float4*>(mo + i) =
            *reinterpret_cast<const float4*>(m + i);
        *reinterpret_cast<float4*>(vo + i) =
            *reinterpret_cast<const float4*>(v + i);
      } else {
        adamw4(h, i, p, m, v, load4(g + i), po, mo, vo);
      }
    } else if (stale) {
      po[i] = p[i];
      mo[i] = m[i];
      vo[i] = v[i];
    } else {
      adamw(h, p[i], m[i], v[i], g[i], po[i], mo[i], vo[i]);
    }
  }
}

bool aligned16(const void* ptr) { return ((uintptr_t)ptr & 15) == 0; }
bool aligned8(const void* ptr) { return ((uintptr_t)ptr & 7) == 0; }
bool aligned_g(const float* g) { return aligned16(g); }
bool aligned_g(const __nv_bfloat16* g) { return aligned8(g); }

template <typename G>
int launch(const float* hp, const float* p, const float* m, const float* v,
           const G* g, float* po, float* mo, float* vo, int64_t n,
           void* stream) {
  const bool vec = aligned16(p) && aligned16(m) && aligned16(v) &&
                   aligned16(po) && aligned16(mo) && aligned16(vo) &&
                   aligned_g(g);
  const int64_t work = vec ? (n + 3) / 4 : n;
  const int blocks = (int)(work < (int64_t)MAX_BLOCKS * THREADS
                               ? (work + THREADS - 1) / THREADS
                               : MAX_BLOCKS);
  if (vec)
    adamw_kernel<G, true><<<blocks, THREADS, 0, (cudaStream_t)stream>>>(
        hp, p, m, v, g, po, mo, vo, n);
  else
    adamw_kernel<G, false><<<blocks, THREADS, 0, (cudaStream_t)stream>>>(
        hp, p, m, v, g, po, mo, vo, n);
  return (int)cudaGetLastError();
}

}  // namespace

// n >= 1 elements of p, m, v, g and of the outputs, contiguous.
extern "C" int pot_adamw_f32g(const float* hp, const float* p, const float* m,
                              const float* v, const float* g, float* po,
                              float* mo, float* vo, int64_t n, void* stream) {
  return launch(hp, p, m, v, g, po, mo, vo, n, stream);
}

extern "C" int pot_adamw_bf16g(const float* hp, const float* p,
                               const float* m, const float* v,
                               const __nv_bfloat16* g, float* po, float* mo,
                               float* vo, int64_t n, void* stream) {
  return launch(hp, p, m, v, g, po, mo, vo, n, stream);
}

// p, m, v, g and the outputs (rows, cols) contiguous with rows and cols
// positive multiples of 256; versions and abort_out (rows/256, cols/256).
extern "C" int pot_adamw_spec(const float* hp, const int* versions,
                              const float* p, const float* m, const float* v,
                              const float* g, float* po, float* mo, float* vo,
                              int* abort_out, int64_t rows, int64_t cols,
                              void* stream) {
  const int64_t n_blocks = rows / BLOCK * (cols / BLOCK);
  const bool vec = aligned16(p) && aligned16(m) && aligned16(v) &&
                   aligned16(g) && aligned16(po) && aligned16(mo) &&
                   aligned16(vo);
  if (vec)
    adamw_spec_kernel<true><<<(unsigned)n_blocks, THREADS, 0,
                              (cudaStream_t)stream>>>(
        hp, versions, p, m, v, g, po, mo, vo, abort_out, cols);
  else
    adamw_spec_kernel<false><<<(unsigned)n_blocks, THREADS, 0,
                               (cudaStream_t)stream>>>(
        hp, versions, p, m, v, g, po, mo, vo, abort_out, cols);
  return (int)cudaGetLastError();
}
