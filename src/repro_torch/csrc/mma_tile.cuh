// Tensor-core building blocks shared by the flash-attention forward (K7)
// and backward (K8), the paged attention (K2 / K3) and the int8 and
// codebook4 FC products (K4 / K5, fc_tile.cuh): bf16 `mma.sync`
// m16n8k16 with f32 accumulators, `ldmatrix` fragment loads from shared
// memory, `cp.async` (also used by the blocked-ACSR SpMV, K1), the split of
// an f32 value into two bf16 halves, and int8 to bf16 (exact).
//
// Split-bf16 precision.  An f32 value x is stored as hi = bf16(x) and
// lo = bf16(x - hi): hi keeps the top 8 significant bits, lo the next 8,
// and what is left is below 2^-16 |x|.  A product of two f32 operands is
// taken as hi*hi + hi*lo + lo*hi (the dropped lo*lo and the residues are
// below ~3 * 2^-17 of |a b|); where one side is exact in bf16 (bf16 inputs)
// two products suffice.  Every product of two bf16 values is exact in f32
// and the tensor cores sum them into f32 accumulators, so the result is
// an f32 sum of terms each within ~2^-16 of the exact product.
//
// Fragments (PTX ISA, mma.m16n8k16 with .row.col): with g = lane / 4 and
// c = lane % 4, A (16 x 16) holds a0 = (g, 2c..2c+1), a1 = (g + 8, 2c..),
// a2 = (g, 2c + 8..), a3 = (g + 8, 2c + 8..); B (16 x 8, k by n) holds
// b0 = (k 2c..2c+1, n g), b1 = (k 2c + 8.., n g); the accumulator C
// (16 x 8) holds c0, c1 = (g, 2c..2c+1), c2, c3 = (g + 8, 2c..2c+1).
#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace mt {

__device__ __forceinline__ uint32_t smem_addr(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

// Four 8 x 8 b16 matrices; lane i gives the address of row i % 8 of
// matrix i / 8 (16 bytes each).
__device__ __forceinline__ void ldsm_x4(uint32_t* r, const void* p) {
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0, %1, %2, %3}, [%4];\n"
      : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
      : "r"(smem_addr(p)));
}
__device__ __forceinline__ void ldsm_x4_t(uint32_t* r, const void* p) {
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0, %1, %2, %3}, "
      "[%4];\n"
      : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
      : "r"(smem_addr(p)));
}
__device__ __forceinline__ void ldsm_x2_t(uint32_t* r, const void* p) {
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x2.trans.shared.b16 {%0, %1}, [%2];\n"
      : "=r"(r[0]), "=r"(r[1])
      : "r"(smem_addr(p)));
}

// d += a * b (bf16 in, f32 accumulate)
__device__ __forceinline__ void mma(float* d, const uint32_t* a,
                                    const uint32_t* b) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, "
      "{%0, %1, %2, %3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b[0]), "r"(b[1]));
}

// Row-major A tile [rows][ld] (bf16): the 16 x 16 fragment at (r0, k0).
__device__ __forceinline__ void load_a(uint32_t* a, const __nv_bfloat16* t,
                                       int ld, int r0, int k0, int lane) {
  const int r = r0 + (lane & 7) + ((lane >> 3) & 1) * 8;
  const int k = k0 + (lane >> 4) * 8;
  ldsm_x4(a, t + r * ld + k);
}

// B fragments of two neighbouring n-tiles (n0 and n0 + 8) at depth k0
// from a tile stored n-major, [n][ld] (the k index contiguous): b[0..1]
// for n-tile n0, b[2..3] for n0 + 8.
__device__ __forceinline__ void load_b_nk(uint32_t* b,
                                          const __nv_bfloat16* t, int ld,
                                          int n0, int k0, int lane) {
  const int n = n0 + (lane & 7) + (lane >> 4) * 8;
  const int k = k0 + ((lane >> 3) & 1) * 8;
  ldsm_x4(b, t + n * ld + k);
}

// The same two n-tiles from a tile stored k-major, [k][ld] (n contiguous).
__device__ __forceinline__ void load_b_kn(uint32_t* b,
                                          const __nv_bfloat16* t, int ld,
                                          int n0, int k0, int lane) {
  const int k = k0 + (lane & 7) + ((lane >> 3) & 1) * 8;
  const int n = n0 + (lane >> 4) * 8;
  ldsm_x4_t(b, t + k * ld + n);
}

// One n-tile from a k-major tile (lanes 0-15 give the addresses).
__device__ __forceinline__ void load_b_kn1(uint32_t* b,
                                           const __nv_bfloat16* t, int ld,
                                           int n0, int k0, int lane) {
  const int k = k0 + (lane & 7) + ((lane >> 3) & 1) * 8;
  ldsm_x2_t(b, t + k * ld + n0);
}

struct Split {
  __nv_bfloat16 hi, lo;
};

__device__ __forceinline__ Split split(float x) {
  Split s;
  s.hi = __float2bfloat16_rn(x);
  s.lo = __float2bfloat16_rn(x - __bfloat162float(s.hi));
  return s;
}

__device__ __forceinline__ uint32_t pack(__nv_bfloat16 a, __nv_bfloat16 b) {
  return (uint32_t)__bfloat16_as_ushort(a) |
         ((uint32_t)__bfloat16_as_ushort(b) << 16);
}

// Accumulator pair (x, y) of neighbouring columns -> hi and lo words:
// split() of each, two values a conversion.
__device__ __forceinline__ void split2(float x, float y, uint32_t& hi,
                                       uint32_t& lo) {
  const __nv_bfloat162 h = __floats2bfloat162_rn(x, y);
  hi = *reinterpret_cast<const uint32_t*>(&h);
  const __nv_bfloat162 l = __floats2bfloat162_rn(
      x - __uint_as_float(hi << 16), y - __uint_as_float(hi & 0xffff0000u));
  lo = *reinterpret_cast<const uint32_t*>(&l);
}

// The A fragment of one k16 step from the accumulators of two neighbouring
// n8 tiles of a 16-row product (c0: columns 0-7, c1: 8-15), each f32 value
// split into bf16 hi + lo: the p of an online softmax enters p . v this way
// without leaving registers or being rounded.
__device__ __forceinline__ void acc_to_a(const float* c0, const float* c1,
                                         uint32_t* hi, uint32_t* lo) {
  split2(c0[0], c0[1], hi[0], lo[0]);
  split2(c0[2], c0[3], hi[1], lo[1]);
  split2(c1[0], c1[1], hi[2], lo[2]);
  split2(c1[2], c1[3], hi[3], lo[3]);
}

// Two int8 values (bytes k and k + 1 of w, k even) as a bf16 pair: exact.
__device__ __forceinline__ uint32_t i8x2_bf16(uint32_t w, int k) {
  const float a = (float)(int8_t)((w >> (8 * k)) & 0xffu);
  const float b = (float)(int8_t)((w >> (8 * k + 8)) & 0xffu);
  return pack(__float2bfloat16_rn(a), __float2bfloat16_rn(b));
}

// A 16-byte piece of 16 int8 values as 16 bf16 values (two pieces).
__device__ __forceinline__ void i8x16_bf16(uint4 raw, uint4& first,
                                           uint4& second) {
  first = make_uint4(i8x2_bf16(raw.x, 0), i8x2_bf16(raw.x, 2),
                     i8x2_bf16(raw.y, 0), i8x2_bf16(raw.y, 2));
  second = make_uint4(i8x2_bf16(raw.z, 0), i8x2_bf16(raw.z, 2),
                      i8x2_bf16(raw.w, 0), i8x2_bf16(raw.w, 2));
}

__device__ __forceinline__ void cp_async16(void* dst, const void* src) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(
                   smem_addr(dst)),
               "l"(src));
}
// 16 bytes from src, or 16 zero bytes when `valid` is false (src is then
// not read)
__device__ __forceinline__ void cp_async16_zfill(void* dst, const void* src,
                                                 bool valid) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(
                   smem_addr(dst)),
               "l"(src), "r"(valid ? 16 : 0));
}
__device__ __forceinline__ void cp_commit() {
  asm volatile("cp.async.commit_group;\n" ::);
}
template <int N>
__device__ __forceinline__ void cp_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N));
}

}  // namespace mt
