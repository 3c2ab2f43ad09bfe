// 3xTF32 products on Hopper's tensor cores: fp32-accurate matrix products
// from TF32 mma.sync.
//
// An fp32 value a splits into a TF32 high part and a TF32 residual,
// a = a_hi + a_lo (a_hi: a rounded to 10 mantissa bits, to nearest with
// ties away from zero; a_lo: the exact fp32 difference, rounded the same
// way).  A product is a_lo*b_hi + a_hi*b_lo + a_hi*b_hi, accumulated in
// fp32; the dropped a_lo*b_lo term and the rounding of the residuals are
// ~2^-22 of the product, so the sum keeps fp32-level accuracy where one
// TF32 product (a_hi*b_hi) keeps ~2^-11.  tests/test_torch_port_tf32x3.py
// runs the same rounding and split in plain torch on the CPU.
#pragma once

#include <cstdint>

namespace tf32x3 {

constexpr uint32_t kHalfUlp = 0x1000u;    // half a TF32 ulp, in fp32 mantissa bits
constexpr uint32_t kMask = 0xffffe000u;   // the bits a TF32 value keeps

// x -> (hi, lo) in the operand form the tensor core reads.  The tensor core
// ignores the low 13 bits of a .tf32 operand, so adding half an ulp is the
// whole of rounding to nearest there; the mask is paid only where the
// rounded value itself is needed, to form the residual.
__device__ __forceinline__ void split(uint32_t x, uint32_t& hi, uint32_t& lo) {
  hi = x + kHalfUlp;
  lo = __float_as_uint(__uint_as_float(x) - __uint_as_float(hi & kMask)) + kHalfUlp;
}

// c += a * b for one m16n8k8 tile: a is 16x8 row-major, b 8x8 column-major,
// c 16x8, in the fragment layouts of the PTX ISA (g = lane / 4, t = lane % 4):
// a = {A[g][t], A[g+8][t], A[g][t+4], A[g+8][t+4]}, b = {B[t][g], B[t+4][g]},
// c = {C[g][2t], C[g][2t+1], C[g+8][2t], C[g+8][2t+1]}.
__device__ __forceinline__ void mma(float (&c)[4], const uint32_t (&a)[4],
                                    const uint32_t (&b)[2]) {
  asm("mma.sync.aligned.m16n8k8.row.col.f32.tf32.tf32.f32 "
      "{%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b[0]), "r"(b[1]));
}

// Four 8x4 fp32 (8x8 b16) matrices from shared memory: lanes 8q..8q+7 give
// the row addresses of matrix q (16-byte aligned), and lane l receives word
// l % 4 of row l / 4 of matrix q in r[q].  That is an A fragment when the
// matrices are rows 0-7 / 8-15 x k 0-3 / 4-7 of a 16x8 tile, and the B
// fragments of two n-tiles when they are n 0-7 / 8-15 x k 0-3 / 4-7 of a
// K-contiguous (n, k) matrix.
__device__ __forceinline__ void ldmatrix_x4(uint32_t (&r)[4], const float* row) {
  const unsigned s = static_cast<unsigned>(__cvta_generic_to_shared(row));
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0,%1,%2,%3}, [%4];\n"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
               : "r"(s));
}

}  // namespace tf32x3
