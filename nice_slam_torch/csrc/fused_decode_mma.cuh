// The tensor-core trunk of the fused NICE decode, shared by the forward
// (K1, fused_decode.cu) and the backward (K2, fused_decode_bwd.cu).
//
// - Img<C>: one decoder's weight image in shared memory, built by the
//   wrapper (ops/fused_decode.py image_index) with one gather.  Each
//   32-wide matrix is row-major with a row stride of 40 floats and its
//   columns XOR ((row & 4) << 1), which makes both the forward B-fragment
//   reads (W[k][n]) and the transposed ones (W[n][k], as float2) free of
//   bank conflicts.  The embedding K=93 and the skip input K=125 are
//   padded to 96 and 128 with zero rows (x3 = [e | 0 0 0 | h2]).
// - Lane: the per-lane part of every fragment address.
// - sincos_fp32 / sin_fp32: branch-free fp32 sin and cos, 2 ulp.
// - 3xTF32 products on the tensor cores (mma.sync m16n8k8 TF32): each
//   operand split into its TF32 rounding and the remainder, small*big +
//   big*small + big*big accumulated in fp32.
// - c_to_a: an mma accumulator used as the next product's A operand
//   without a shuffle (the k order inside each 8-wide k-block permuted,
//   the weights' B fragments read with the same permutation); mm_fwd: the
//   product of such an operand with a 32-wide matrix of the image.

#pragma once

#include <cuda_runtime.h>
#include <stdint.h>

#include "fused_decode_layout.cuh"

namespace nice_decode {

constexpr int EP = 96;  // embedding width padded to 12 k-blocks
constexpr int WS = 40;  // shared-memory row stride of a 32-wide matrix

// Shared-memory image of one decoder (offsets in floats), built by the
// wrapper (ops/fused_decode.py image_index) from the weights.
template <int C>
struct Img {
  static constexpr int B = 0;                     // [3][96]
  static constexpr int W0 = 3 * EP;               // 96 rows (93.. zero)
  static constexpr int W1 = W0 + EP * WS;         // 32 rows
  static constexpr int W2 = W1 + HID * WS;        // 32 rows
  static constexpr int W3 = W2 + HID * WS;        // 128 rows: e | 0 | h2
  static constexpr int W4 = W3 + (EP + HID) * WS; // 32 rows
  static constexpr int b = W4 + HID * WS;         // 5 x 32
  static constexpr int a = b + NBLK * HID;        // 5 x 32
  static constexpr int Wo = a + NBLK * HID;       // [32][4], zero past O
  static constexpr int bo = Wo + HID * 4;         // 4
  static constexpr int V = bo + 4;                // 5 x C rows
  static constexpr int size = V + NBLK * C * WS;
};

constexpr int IMG_MID = 0;
constexpr int IMG_FINE = IMG_MID + Img<HID>::size;
constexpr int IMG_COLOR = IMG_FINE + Img<2 * HID>::size;
constexpr int IMG_TOTAL = IMG_COLOR + Img<HID>::size;

static_assert(Img<HID>::size % 4 == 0 && Img<2 * HID>::size % 4 == 0,
              "cp.async copies 16 bytes");

__host__ __device__ constexpr int img_off(int d) {
  return d == 0 ? IMG_MID : d == 1 ? IMG_FINE : IMG_COLOR;
}
__host__ __device__ constexpr int img_size(int d) {
  return d == 1 ? Img<2 * HID>::size : Img<HID>::size;
}

// offset of W_i inside a decoder's image (identical for both widths)
__device__ __forceinline__ int img_w(int i) {
  return i == 0 ? Img<HID>::W0
       : i == 1 ? Img<HID>::W1
       : i == 2 ? Img<HID>::W2
       : i == 3 ? Img<HID>::W3
                : Img<HID>::W4;
}

// Element (r, c) of a 32-wide matrix lies at r * WS + (c ^ ((r & 4) << 1))
// of its image.  The XOR term of a fragment read depends only on the lane
// and on the parity of the 8-wide block index, so every read is a lane
// base plus a compile-time offset:
//   forward    W[8kb + 2t + j][8nb + g]: f[nb & 1] + 8 WS kb + WS j + 8nb
//   transposed W[8nb + g][8kb + 2t : +2]: r[kb & 1] + 8 WS nb + 8kb
struct Lane {
  int g, t;
  int f[2], r[2];
};

__device__ __forceinline__ Lane lane_offsets(int lane) {
  Lane L;
  L.g = lane >> 2;
  L.t = lane & 3;
  const int s = 8 * (L.t >> 1), u = 8 * (L.g >> 2);
  L.f[0] = 2 * L.t * WS + L.g + s;
  L.f[1] = 2 * L.t * WS + L.g - s;
  L.r[0] = L.g * WS + 2 * L.t + u;
  L.r[1] = L.g * WS + 2 * L.t - u;
  return L;
}

__device__ __forceinline__ void cp_async16(float* dst, const float* src) {
  const unsigned s = (unsigned)__cvta_generic_to_shared(dst);
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(s),
               "l"(src));
}

__device__ __forceinline__ void cp_async_wait_all() {
  asm volatile("cp.async.commit_group;\n" ::);
  asm volatile("cp.async.wait_group 0;\n" ::: "memory");
}

// sin(x) and cos(x) in fp32 without a branch: x = j pi/2 + r with
// j = rint(x 2/pi) and r from a three-step FMA reduction (pi/2 split into
// three floats, 2^-76 left over), then the minimax polynomials of Cephes'
// sinf/cosf on |r| <= pi/4 and the quadrant of j.  Error below 2 ulp
// against double precision for |x| < 1.5e5 (tests/test_torch_kernels.py,
// test_sincos_fp32_accuracy), the bound CUDA gives for sinf/cosf; the
// decoder's arguments are O(100).  The library's sincosf branches to a
// slow path for huge arguments, which kept the compiler from interleaving
// the evaluations: they were 45% of the backward kernel's time.
__device__ __forceinline__ void sincos_fp32(float x, float* s, float* c) {
  const float j = rintf(x * 0.636619747f);
  float r = fmaf(j, -1.57079637f, x);
  r = fmaf(j, 4.37113883e-08f, r);
  r = fmaf(j, 1.71512451e-15f, r);
  const float z = r * r;
  float ps = fmaf(z, -1.95152959e-4f, 8.33216087e-3f);
  ps = fmaf(z, ps, -1.66666546e-1f);
  const float sr = fmaf(r * z, ps, r);
  float pc = fmaf(z, 2.44331571e-5f, -1.38873163e-3f);
  pc = fmaf(z, pc, 4.16666457e-2f);
  pc = fmaf(z, pc, -0.5f);
  const float cr = fmaf(z, pc, 1.0f);
  const int q = (int)j;
  const float sv = (q & 1) ? cr : sr;
  const float cv = (q & 1) ? sr : cr;
  *s = (q & 2) ? -sv : sv;
  *c = ((q + 1) & 2) ? -cv : cv;
}

// sin(x) alone: sincos_fp32's reduction and polynomials (the quadrant can
// pick either), its cosine left to dead-code elimination.
__device__ __forceinline__ float sin_fp32(float x) {
  float s, c;
  sincos_fp32(x, &s, &c);
  return s;
}

// ---------------------------------------------------------------------------
// 3xTF32 on the tensor cores

__device__ __forceinline__ uint32_t to_tf32(float x) {
  uint32_t r;
  asm("cvt.rna.tf32.f32 %0, %1;\n" : "=r"(r) : "f"(x));
  return r;
}

// x = big + small: big = x rounded to TF32, small = x - big (exact in
// fp32).  small goes to the tensor core unrounded: the core reads the top
// 19 bits of a TF32 operand, which leaves an error below 2^-21 |x| (the
// round-toward-zero form of CUTLASS's fast 3xTF32); a second cvt would
// cost three more instructions per operand.
__device__ __forceinline__ void split_tf32(float x, uint32_t& big,
                                           uint32_t& small) {
  big = to_tf32(x);
  small = __float_as_uint(x - __uint_as_float(big));
}

// The same split for a weight, which is finite: the rounding by integer
// add-and-mask gives cvt.rna's result without its test for infinity (two
// instructions instead of three, on the operand split most often).
__device__ __forceinline__ void split_w(float x, uint32_t& big,
                                       uint32_t& small) {
  big = (__float_as_uint(x) + 0x1000u) & 0xffffe000u;
  small = __float_as_uint(x - __uint_as_float(big));
}

struct AFrag {
  uint32_t hi[4], lo[4];
};

// a: the A fragment in mma order (a0 (g, k=t), a1 (g+8, t), a2 (g, t+4),
// a3 (g+8, t+4))
__device__ __forceinline__ AFrag split_a(const float (&a)[4]) {
  AFrag f;
#pragma unroll
  for (int r = 0; r < 4; ++r) split_tf32(a[r], f.hi[r], f.lo[r]);
  return f;
}

__device__ __forceinline__ void mma_tf32(float (&d)[4], const uint32_t (&a)[4],
                                         uint32_t b0, uint32_t b1) {
  asm("mma.sync.aligned.m16n8k8.row.col.f32.tf32.tf32.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// d += a * b in 3xTF32 (small*big + big*small + big*big), b already split
__device__ __forceinline__ void mma3_split(float (&d)[4], const AFrag& a,
                                           uint32_t b0h, uint32_t b1h,
                                           uint32_t b0l, uint32_t b1l) {
  mma_tf32(d, a.lo, b0h, b1h);
  mma_tf32(d, a.hi, b0l, b1l);
  mma_tf32(d, a.hi, b0h, b1h);
}

// d += a * b in 3xTF32, b a weight fragment
__device__ __forceinline__ void mma3(float (&d)[4], const AFrag& a, float b0,
                                     float b1) {
  uint32_t b0h, b0l, b1h, b1l;
  split_w(b0, b0h, b0l);
  split_w(b1, b1h, b1l);
  mma3_split(d, a, b0h, b1h, b0l, b1l);
}

// d += a * b in 3xTF32, b an activation fragment
__device__ __forceinline__ void mma3_act(float (&d)[4], const AFrag& a,
                                         float b0, float b1) {
  uint32_t b0h, b0l, b1h, b1l;
  split_tf32(b0, b0h, b0l);
  split_tf32(b1, b1h, b1l);
  mma3_split(d, a, b0h, b1h, b0l, b1l);
}

// An accumulator (16 x 32, C layout: c0 (g, 2t), c1 (g, 2t+1), c2 (g+8,
// 2t), c3 (g+8, 2t+1) of each 8-column block) as the A operand of a
// product over its 32 columns: k-block kb, with k = t <-> column 2t and
// k = t + 4 <-> column 2t + 1.
__device__ __forceinline__ void c_to_a(const float (&c)[4][4],
                                       float (&a)[4][4]) {
#pragma unroll
  for (int kb = 0; kb < 4; ++kb) {
    a[kb][0] = c[kb][0];
    a[kb][1] = c[kb][2];
    a[kb][2] = c[kb][1];
    a[kb][3] = c[kb][3];
  }
}

// acc (16 x 32) += x (16 x 8KB, A fragments) . M[0 : 8KB, 0 : 32]
template <int KB>
__device__ __forceinline__ void mm_fwd(float (&acc)[4][4],
                                       const float (&x)[KB][4],
                                       const float* M, const Lane& L) {
  const float* M0 = M + L.f[0];
  const float* M1 = M + L.f[1];
#pragma unroll
  for (int kb = 0; kb < KB; ++kb) {
    const AFrag A = split_a(x[kb]);
#pragma unroll
    for (int nb = 0; nb < 4; ++nb) {
      const float* q = (nb & 1 ? M1 : M0) + 8 * WS * kb + 8 * nb;
      mma3(acc[nb], A, q[0], q[WS]);
    }
  }
}

__device__ __forceinline__ unsigned relu_bits(const float (&z)[4][4]) {
  unsigned m = 0u;
#pragma unroll
  for (int nb = 0; nb < 4; ++nb)
#pragma unroll
    for (int r = 0; r < 4; ++r) m |= (z[nb][r] > 0.f ? 1u : 0u) << (4 * nb + r);
  return m;
}

}  // namespace nice_decode
