// Fused NICE decode, backward (K2), for Hopper (sm_90a).
//
// Replaces the Pallas TPU kernel _bwd_kernel of
// nice_slam_tpu/ops/pallas/fused_decode.py (fused_decode.py:192-253,
// launched by _bwd_rule at :304): per point, the hand VJP of the middle,
// fine and (colour stage) colour MLPs, recomputing their forward; dp, the
// feature cotangents and, for the decoders that train, the weight gradients
// summed over all points.
//
// What bounds it on the H100: the work is matrix products of width 32
// (x W_i, c V_i forward; dz W_i^T, dh V_i^T backward; x_i^T dz, c^T dh for
// the weight gradients), ~100k MAC per colour-stage point against ~800
// bytes of point I/O, so it is bound by arithmetic.  In fp32 on the CUDA
// cores that is 67 TFLOP/s; here every product of width 32 runs on the
// tensor cores (mma.sync m16n8k8 TF32) as 3xTF32 (each operand split into
// its TF32 rounding and the remainder, small*big + big*small + big*big
// accumulated in fp32), which keeps fp32-level error at up to 495/3
// TFLOP/s.  The embedding (p.B, K=3), its backward (dp = dpre B^T, N=3;
// dB = p^T dpre) and the heads (O <= 4) stay SIMT fp32, with sin and cos
// accurate to 2 ulp like sinf/cosf (sincos_fp32; never the fast
// intrinsics: the arguments reach O(100)).
//
// Design:
// - Decoder-major grid (tiles of 64 points, decoders): a block stages ONE
//   decoder's weights into shared memory once with cp.async, overlapped
//   with loading the tile's points, cotangents and features.
//   Each decoder block writes its own share of dp (dp_part[d]) and its own
//   feature cotangent (middle: dc_mid, fine: the 32 c_fine rows only,
//   colour: dc_color).  The wrapper sums dp_part in a fixed order.
// - A warp owns 16 points.  Its activations stay in registers as mma
//   accumulator fragments; the ReLU pattern of each block is kept as 16
//   bits per lane.  An accumulator is used as the next product's A operand
//   without any shuffle: the K order inside each 8-wide k-block is
//   permuted (logical k = t <-> column 2t, k = t + 4 <-> column 2t + 1),
//   and the weights' B fragments are read with the same permutation.
// - Weights in shared memory: each 32-wide matrix is stored with a row
//   stride of 40 floats and column XOR ((row & 4) << 1), which makes both
//   the forward B-fragment reads (W[k][n]) and the transposed ones
//   (W[n][k], as float2) free of bank conflicts.  The wrapper builds this
//   image from the packed buffer with one indexed gather.  The embedding
//   K=93 and the skip input K=125 are padded to 96 and 128 with zero rows
//   (x3 = [e | 0 0 0 | h2]).
// - Weight gradients only for the decoders that train (the `live` mask),
//   in a second launch of the same kernel (LIVE = true) whose blocks also
//   keep the tile's inputs x_i, dz, dh, c in shared memory and take the
//   weight-gradient products over the tile's 64 points on the tensor
//   cores.  Each (tile, live decoder) writes one partial row in the
//   packed layout; nice_wgrad_reduce_kernel sums the rows in a fixed order
//   (deterministic, no atomics).  Decoders that do not train get no
//   weight-gradient work, tile or partial row.

#include <cuda_runtime.h>
#include <stdint.h>

#include "fused_decode_layout.cuh"

namespace {

using namespace nice_decode;

constexpr int WARPS = 4;
constexpr int THREADS = 32 * WARPS;
constexpr int TPTS = 16 * WARPS;  // points per tile (a warp owns 16)
constexpr int EP = 96;            // embedding width padded to 12 k-blocks
constexpr int WS = 40;            // shared-memory row stride of a 32-wide matrix

// Shared-memory image of one decoder (offsets in floats), built by the
// wrapper (ops/fused_decode.py bwd_image_index) from the packed buffer.
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

// shared-memory tiles of a LIVE block (after the weight image), floats
constexpr int XS = EP + NBLK * HID + 8;  // [e | h0 .. h4], stride 264
constexpr int DS = HID + 8;              // dz, dh: stride 40
constexpr int PS = 8;                    // p (0..2), head cotangent (4..7)
// the remainder of the split dz, in the X tile's h_4 columns (free once
// dWo is taken)
constexpr int DZLO = EP + 4 * HID;
template <int C>
struct Tiles {
  static constexpr int CS = C + 8;  // feature rows
  static constexpr int X = Img<C>::size;
  static constexpr int DZ = X + TPTS * XS;
  static constexpr int DH = DZ + TPTS * DS;
  static constexpr int CT = DH + TPTS * DS;
  static constexpr int PT = CT + TPTS * CS;
  static constexpr int BS = PT + TPTS * PS;  // [warp][dz sums | dh sums]
  static constexpr int size = BS + WARPS * 2 * HID;
};

constexpr size_t FROZEN_SMEM_MAX = sizeof(float) * Img<2 * HID>::size;
constexpr size_t LIVE_SMEM_MAX = sizeof(float) * Tiles<2 * HID>::size;
static_assert(LIVE_SMEM_MAX <= 232448, "exceeds Hopper shared memory");

__host__ __device__ constexpr int img_off(int d) {
  return d == 0 ? IMG_MID : d == 1 ? IMG_FINE : IMG_COLOR;
}
__host__ __device__ constexpr int img_size(int d) {
  return d == 1 ? Img<2 * HID>::size : Img<HID>::size;
}
__host__ __device__ constexpr int flat_off(int d) {
  return d == 0 ? MID_OFF : d == 1 ? FINE_OFF : COLOR_OFF;
}
__host__ __device__ constexpr int flat_size(int d) {
  return d == 0 ? LMid::size : d == 1 ? LFine::size : LColor::size;
}

// offset of W_i inside a decoder's image (identical for both widths)
__device__ __forceinline__ int img_w(int i) {
  return i == 0 ? Img<HID>::W0
       : i == 1 ? Img<HID>::W1
       : i == 2 ? Img<HID>::W2
       : i == 3 ? Img<HID>::W3
                : Img<HID>::W4;
}

// offset of W_i inside a decoder's packed section (Layout)
__device__ __forceinline__ int flat_w(int i) {
  return i == 0 ? LMid::W0
       : i == 1 ? LMid::W1
       : i == 2 ? LMid::W2
       : i == 3 ? LMid::W3
                : LMid::W4;
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
// the evaluations: they were 45% of this kernel's time.
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

// acc (16 x 8NB) += y (16 x 32, A fragments) . M[0 : 8NB, 0 : 32]^T
template <int NB>
__device__ __forceinline__ void mm_bwd(float (&acc)[NB][4],
                                       const float (&y)[4][4],
                                       const float* M, const Lane& L) {
  const float* M0 = M + L.r[0];
  const float* M1 = M + L.r[1];
#pragma unroll
  for (int kb = 0; kb < 4; ++kb) {
    const AFrag A = split_a(y[kb]);
#pragma unroll
    for (int nb = 0; nb < NB; ++nb) {
      const float2 v = *reinterpret_cast<const float2*>(
          (kb & 1 ? M1 : M0) + 8 * WS * nb + 8 * kb);
      mma3(acc[nb], A, v.x, v.y);
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

// store an accumulator's 16 rows into a row-major tile (row0 = the warp's
// first row, ld = row stride, col0 = first column)
__device__ __forceinline__ void store_acc(float* T, int ld, int row0, int col0,
                                          const float (&c)[4][4], int g,
                                          int t) {
#pragma unroll
  for (int nb = 0; nb < 4; ++nb) {
    const int col = col0 + 8 * nb + 2 * t;
    *reinterpret_cast<float2*>(T + (row0 + g) * ld + col) =
        make_float2(c[nb][0], c[nb][1]);
    *reinterpret_cast<float2*>(T + (row0 + g + 8) * ld + col) =
        make_float2(c[nb][2], c[nb][3]);
  }
}

// store dz (C layout) split: its TF32 rounding into the DZ tile (stride
// DS), the remainder into lo (stride XS)
__device__ __forceinline__ void store_split(float* hi, float* lo, int row0,
                                            const float (&c)[4][4], int g,
                                            int t) {
#pragma unroll
  for (int nb = 0; nb < 4; ++nb)
#pragma unroll
    for (int half = 0; half < 2; ++half) {
      const float v0 = c[nb][2 * half], v1 = c[nb][2 * half + 1];
      const float h0 = __uint_as_float(to_tf32(v0));
      const float h1 = __uint_as_float(to_tf32(v1));
      const int r = row0 + g + 8 * half, col = 8 * nb + 2 * t;
      *reinterpret_cast<float2*>(hi + r * DS + col) = make_float2(h0, h1);
      *reinterpret_cast<float2*>(lo + r * XS + col) =
          make_float2(v0 - h0, v1 - h1);
    }
}

// ---------------------------------------------------------------------------
// The kernel

struct BwdArgs {
  const float* p;
  const float* cm;
  const float* cf;
  const float* cc;
  const float* g;
  const float* wimg;  // the three decoders' shared-memory images
  float* dp_part;     // [3][n][3]: each decoder's share of dp
  float* dcm;
  float* dcf;
  float* dcc;
  float* partial;     // LIVE: one row per (tile, live decoder)
  int n;
  int dec[3];           // blockIdx.y -> decoder (0 middle, 1 fine, 2 colour)
  long long pbase[3];   // LIVE: blockIdx.y -> first float of its partial rows
};

// acc (16 x 32) = S[:, col0 : col0 + 16]^T D over the tile's 64 points
// (row-major tiles, strides ls and DS).  SPLIT: D holds the TF32 rounding
// of the operand and Dlo (stride XS) the remainder.  Two accumulators over
// the two halves of the points: twice the independent mma chains.
template <bool SPLIT>
__device__ __forceinline__ void slab_mm(float (&acc)[4][4], const float* S,
                                        int ls, int col0, const float* D,
                                        const float* Dlo, int g, int t) {
  float acc2[4][4] = {};
#pragma unroll
  for (int nb = 0; nb < 4; ++nb)
#pragma unroll
    for (int r = 0; r < 4; ++r) acc[nb][r] = 0.f;
#pragma unroll
  for (int ks = 0; ks < TPTS / 8; ++ks) {
    const float* s0 = S + (8 * ks + t) * ls + col0 + g;
    const float* s1 = s0 + 4 * ls;
    const float av[4] = {s0[0], s0[8], s1[0], s1[8]};
    const AFrag A = split_a(av);
#pragma unroll
    for (int nb = 0; nb < 4; ++nb) {
      float(&a)[4] = ks < TPTS / 16 ? acc[nb] : acc2[nb];
      const float* d0 = D + (8 * ks + t) * DS + 8 * nb + g;
      if (SPLIT) {
        const float* l0 = Dlo + (8 * ks + t) * XS + 8 * nb + g;
        mma3_split(a, A, __float_as_uint(d0[0]), __float_as_uint(d0[4 * DS]),
                   __float_as_uint(l0[0]), __float_as_uint(l0[4 * XS]));
      } else {
        mma3_act(a, A, d0[0], d0[4 * DS]);
      }
    }
  }
#pragma unroll
  for (int nb = 0; nb < 4; ++nb)
#pragma unroll
    for (int r = 0; r < 4; ++r) acc[nb][r] += acc2[nb][r];
}

// Weight gradients of trunk block i over the tile's 64 points (every
// thread of the block calls this): dW_i = x_i^T dz and dV_i = c^T dh on the
// tensor cores, one 16-row slab of one matrix per warp and step;
// db_i = sum dz, da_i = sum dh.  Written into the partial row in the
// packed layout.
template <int C>
__device__ void wgrad_block(const float* sm, float* prow, int i, int warp,
                            int lane) {
  using T = Tiles<C>;
  const int g = lane >> 2, t = lane & 3;
  const int mt_w = i == 0 ? 6 : i == 3 ? 8 : 2;  // 16-row slabs of W_i
  const int items = mt_w + C / 16;
#pragma unroll 1
  for (int it = warp; it < items; it += WARPS) {
    const bool is_w = it < mt_w;
    const int m0 = 16 * (is_w ? it : it - mt_w);  // first row of the slab
    const float* S;
    const float* D;
    int ls, col0;
    if (is_w) {
      S = sm + T::X;
      D = sm + T::DZ;
      ls = XS;
      // x_0 = e, x_3 = [e | 0 | h2], x_i = h_{i-1}: columns of the X tile
      col0 = (i == 0 || (i == 3 && m0 < EP))
                 ? m0
                 : EP + HID * (i == 3 ? 2 : i - 1) + m0 - (i == 3 ? EP : 0);
    } else {
      S = sm + T::CT;
      D = sm + T::DH;
      ls = T::CS;
      col0 = m0;
    }
    float acc[4][4];
    if (is_w)  // dz: split when it was stored
      slab_mm<true>(acc, S, ls, col0, D, sm + T::X + DZLO, g, t);
    else
      slab_mm<false>(acc, S, ls, col0, D, nullptr, g, t);
#pragma unroll
    for (int half = 0; half < 2; ++half) {
      int r = m0 + g + 8 * half;  // padded input row
      int dst;
      if (is_w) {
        if ((i == 0 || i == 3) && r >= EMB && r < EP) continue;  // padding
        if (i == 3 && r >= EP) r -= EP - EMB;
        dst = flat_w(i) + r * HID;
      } else {
        dst = LMid::V + (i * C + r) * HID;
      }
#pragma unroll
      for (int nb = 0; nb < 4; ++nb)
        *reinterpret_cast<float2*>(prow + dst + 8 * nb + 2 * t) =
            make_float2(acc[nb][2 * half], acc[nb][2 * half + 1]);
    }
  }
  // db_i, da_i: the warps' column sums (col_sums), added in warp order
  const int tid = threadIdx.x;
  if (tid < 2 * HID) {
    const float* BS = sm + T::BS + tid;
    float s = 0.f;
#pragma unroll
    for (int w = 0; w < WARPS; ++w) s += BS[w * 2 * HID];
    prow[(tid < HID ? LMid::b : Layout<C, 1>::a) + i * HID + (tid & (HID - 1))] =
        s;
  }
}

// The column sums of a warp's 16 rows of dz and dh (C layout) into
// BS[warp][0:32] and BS[warp][32:64]: rows g and g + 8 in the lane, then a
// butterfly over the eight lanes of a column.
__device__ __forceinline__ void col_sums(float* BS, const float (&dz)[4][4],
                                         const float (&dh)[4][4], int g,
                                         int t) {
#pragma unroll
  for (int nb = 0; nb < 4; ++nb)
#pragma unroll
    for (int j = 0; j < 2; ++j) {
      float a = dz[nb][j] + dz[nb][2 + j];
      float b = dh[nb][j] + dh[nb][2 + j];
#pragma unroll
      for (int m = 4; m < 32; m <<= 1) {
        a += __shfl_xor_sync(0xffffffffu, a, m);
        b += __shfl_xor_sync(0xffffffffu, b, m);
      }
      if (g == 0) {
        BS[8 * nb + 2 * t + j] = a;
        BS[HID + 8 * nb + 2 * t + j] = b;
      }
    }
}

// The VJP of decoder d (feature width C) for the block's tile.
template <int C, bool LIVE>
__device__ __forceinline__ void decoder_bwd(const BwdArgs& a, int slot,
                                            int d, float* sm) {
  using I = Img<C>;
  using T = Tiles<C>;
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const Lane L = lane_offsets(lane);
  const int g = L.g, t = L.t;
  const int lrow = 16 * warp;                       // warp's first tile row
  const int ra = blockIdx.x * TPTS + lrow + g;      // the lane's two points
  const int rb = ra + 8;
  const bool va = ra < a.n, vb = rb < a.n;
  const int O = d == 2 ? 4 : 1;

  // stage the weight image; meanwhile load the points and embed them
  const float* wg = a.wimg + img_off(d);
  for (int q = tid; q < I::size / 4; q += THREADS)
    cp_async16(sm + 4 * q, wg + 4 * q);

  float pa[3], pb[3];
#pragma unroll
  for (int j = 0; j < 3; ++j) {
    pa[j] = va ? a.p[3 * (size_t)ra + j] : 0.f;
    pb[j] = vb ? a.p[3 * (size_t)rb + j] : 0.f;
  }
  const float4 z4 = make_float4(0.f, 0.f, 0.f, 0.f);
  const float4 ga = va ? reinterpret_cast<const float4*>(a.g)[ra] : z4;
  const float4 gb = vb ? reinterpret_cast<const float4*>(a.g)[rb] : z4;
  // head cotangent: occupancy for middle/fine, rgb for colour
  const float dout_a[4] = {d == 2 ? ga.x : ga.w, d == 2 ? ga.y : 0.f,
                           d == 2 ? ga.z : 0.f, 0.f};
  const float dout_b[4] = {d == 2 ? gb.x : gb.w, d == 2 ? gb.y : 0.f,
                           d == 2 ? gb.z : 0.f, 0.f};

  // features as A fragments (k-block kb: columns 8kb + 2t, 8kb + 2t + 1);
  // the fine decoder reads [c_fine | c_mid]
  float cfr[C / 8][4];
  const float* csrc = d == 0 ? a.cm : d == 1 ? a.cf : a.cc;
#pragma unroll
  for (int kb = 0; kb < C / 8; ++kb) {
    const float* src = kb >= 4 ? a.cm : csrc;
    const int col = 8 * (kb & 3) + 2 * t;
    const float2 z2 = make_float2(0.f, 0.f);
    const float2 xa =
        va ? *reinterpret_cast<const float2*>(src + (size_t)ra * HID + col) : z2;
    const float2 xb =
        vb ? *reinterpret_cast<const float2*>(src + (size_t)rb * HID + col) : z2;
    cfr[kb][0] = xa.x;
    cfr[kb][1] = xb.x;
    cfr[kb][2] = xa.y;
    cfr[kb][3] = xb.y;
  }

  if (LIVE) {
    // the tile's inputs for the weight-gradient products (e: in block 0)
    float* CT = sm + T::CT;
#pragma unroll
    for (int kb = 0; kb < C / 8; ++kb) {
      const int col = 8 * kb + 2 * t;
      *reinterpret_cast<float2*>(CT + (lrow + g) * T::CS + col) =
          make_float2(cfr[kb][0], cfr[kb][2]);
      *reinterpret_cast<float2*>(CT + (lrow + g + 8) * T::CS + col) =
          make_float2(cfr[kb][1], cfr[kb][3]);
    }
    if (t == 0) {
      float* PA = sm + T::PT + (lrow + g) * PS;
      float* PB = PA + 8 * PS;
#pragma unroll
      for (int j = 0; j < 3; ++j) {
        PA[j] = pa[j];
        PB[j] = pb[j];
      }
      PA[3] = PB[3] = 0.f;
#pragma unroll
      for (int o = 0; o < 4; ++o) {
        PA[4 + o] = dout_a[o];
        PB[4 + o] = dout_b[o];
      }
    }
  }
  cp_async_wait_all();
  __syncthreads();

  // forward: z_i = x_i W_i + b_i, h_i = relu(z_i) + a_i + c V_i.  The
  // embedding enters blocks 0 and 3: both its products are taken in block
  // 0, each k-block of e = sin(p.B) computed where it is used, and z3e
  // carries the e part of z_3 (16 registers instead of e's 48).  One
  // sincos gives e and the cosine that the embedding backward needs.
  float h[4][4] = {};
  float z3e[4][4] = {};
  float ce[12][4];  // cos(p.B) at e's entries, for the embedding backward
  unsigned m01 = 0u, m23 = 0u, m4 = 0u;  // relu patterns, 16 bits a block
#pragma unroll 1
  for (int i = 0; i < NBLK; ++i) {
    const float* W = sm + img_w(i);
    const float* bi = sm + I::b + i * HID;
    const float* ai = sm + I::a + i * HID;
    float z[4][4];
#pragma unroll
    for (int nb = 0; nb < 4; ++nb) {
      const int c = 8 * nb + 2 * t;
      z[nb][0] = z[nb][2] = bi[c];
      z[nb][1] = z[nb][3] = bi[c + 1];
    }
    if (i == 0) {
      const float* Bs = sm + I::B;
      const float* W3 = sm + I::W3;
#pragma unroll
      for (int kb = 0; kb < 12; ++kb) {
        // A fragment of e: columns 8kb + 2t (+1) of the lane's two rows
        float e[4];
#pragma unroll
        for (int j = 0; j < 2; ++j) {
          const int k = 8 * kb + 2 * t + j;
          const float b0 = Bs[k], b1 = Bs[EP + k], b2 = Bs[2 * EP + k];
          sincos_fp32(fmaf(pa[2], b2, fmaf(pa[1], b1, pa[0] * b0)),
                      &e[2 * j], &ce[kb][2 * j]);
          sincos_fp32(fmaf(pb[2], b2, fmaf(pb[1], b1, pb[0] * b0)),
                      &e[2 * j + 1], &ce[kb][2 * j + 1]);
        }
        if (LIVE) {
          float* X = sm + T::X;
          const int col = 8 * kb + 2 * t;
          *reinterpret_cast<float2*>(X + (lrow + g) * XS + col) =
              make_float2(e[0], e[2]);
          *reinterpret_cast<float2*>(X + (lrow + g + 8) * XS + col) =
              make_float2(e[1], e[3]);
        }
        const AFrag A = split_a(e);
#pragma unroll
        for (int nb = 0; nb < 4; ++nb) {
          const int o = L.f[nb & 1] + 8 * WS * kb + 8 * nb;
          mma3(z[nb], A, W[o], W[o + WS]);
          mma3(z3e[nb], A, W3[o], W3[o + WS]);
        }
      }
    } else {
      if (i == 3) {
#pragma unroll
        for (int nb = 0; nb < 4; ++nb)
#pragma unroll
          for (int r = 0; r < 4; ++r) z[nb][r] += z3e[nb][r];
      }
      float x[4][4];
      c_to_a(h, x);
      mm_fwd<4>(z, x, W + (i == 3 ? EP * WS : 0), L);
    }
    const unsigned bits = relu_bits(z);
    if (i < 2)
      m01 |= bits << (16 * i);
    else if (i < 4)
      m23 |= bits << (16 * (i - 2));
    else
      m4 = bits;
#pragma unroll
    for (int nb = 0; nb < 4; ++nb) {
      const int c = 8 * nb + 2 * t;
      h[nb][0] = h[nb][2] = ai[c];
      h[nb][1] = h[nb][3] = ai[c + 1];
    }
    mm_fwd<C / 8>(h, cfr, sm + I::V + i * C * WS, L);
#pragma unroll
    for (int nb = 0; nb < 4; ++nb)
#pragma unroll
      for (int r = 0; r < 4; ++r) h[nb][r] += fmaxf(z[nb][r], 0.f);
    if (LIVE) store_acc(sm + T::X, XS, lrow, EP + HID * i, h, g, t);
  }

  // head: dh_4 = dout Wo^T (Wo zero past O)
  float dh[4][4];
  {
    const float* Wo = sm + I::Wo;
#pragma unroll
    for (int nb = 0; nb < 4; ++nb)
#pragma unroll
      for (int j = 0; j < 2; ++j) {
        const float* w = Wo + 4 * (8 * nb + 2 * t + j);
        float sa = 0.f, sb = 0.f;
#pragma unroll
        for (int o = 0; o < 4; ++o) {
          sa = fmaf(dout_a[o], w[o], sa);
          sb = fmaf(dout_b[o], w[o], sb);
        }
        dh[nb][j] = sa;
        dh[nb][2 + j] = sb;
      }
  }
  float* prow = nullptr;
  if (LIVE) {
    prow = a.partial + a.pbase[slot] + (size_t)blockIdx.x * flat_size(d);
    __syncthreads();  // h_4 and the head cotangents of the tile are in place
    // dWo = h_4^T dout, dbo = sum dout
    const float* X = sm + T::X;
    const float* PT = sm + T::PT;
    const int k = tid >> 2, o = tid & 3;
    float s = 0.f;
    for (int pt = 0; pt < TPTS; ++pt)
      s = fmaf(X[pt * XS + EP + 4 * HID + k], PT[pt * PS + 4 + o], s);
    const int wo = Layout<C, 1>::Wo;
    if (o < O) prow[wo + k * O + o] = s;
    if (tid < 4) {
      float sb = 0.f;
      for (int pt = 0; pt < TPTS; ++pt) sb += PT[pt * PS + 4 + tid];
      prow[wo + HID * O + tid] = tid < O ? sb : 0.f;  // bo and its padding
    }
    __syncthreads();  // h_4 read: its columns take the remainder of dz
  }

  // backward through the five blocks
  float de[12][4] = {};  // cotangent of e (C layout, 96 columns)
  float dc[4][4] = {};   // cotangent of the first 32 feature columns
#pragma unroll 1
  for (int i = NBLK - 1; i >= 0; --i) {
    const float* W = sm + img_w(i);
    float y[4][4];
    c_to_a(dh, y);
    mm_bwd<4>(dc, y, sm + I::V + i * C * WS, L);  // dc += dh V_i[:32]^T
    const unsigned m = i < 2 ? m01 >> (16 * i)
                     : i < 4 ? m23 >> (16 * (i - 2))
                             : m4;
    float dz[4][4];
#pragma unroll
    for (int nb = 0; nb < 4; ++nb)
#pragma unroll
      for (int r = 0; r < 4; ++r)
        dz[nb][r] = ((m >> (4 * nb + r)) & 1u) ? dh[nb][r] : 0.f;
    if (LIVE) {
      store_split(sm + T::DZ, sm + T::X + DZLO, lrow, dz, g, t);
      store_acc(sm + T::DH, DS, lrow, 0, dh, g, t);
      col_sums(sm + T::BS + warp * 2 * HID, dz, dh, g, t);
      __syncthreads();
      wgrad_block<C>(sm, prow, i, warp, lane);
      __syncthreads();
    }
    c_to_a(dz, y);
    if (i == 0 || i == 3) mm_bwd<12>(de, y, W, L);  // e part of x_i
    if (i != 0) {
      float dn[4][4] = {};
      mm_bwd<4>(dn, y, W + (i == 3 ? EP * WS : 0), L);
#pragma unroll
      for (int nb = 0; nb < 4; ++nb)
#pragma unroll
        for (int r = 0; r < 4; ++r) dh[nb][r] = dn[nb][r];
    }
  }

  // embedding: dpre = de * cos(p.B), dp = dpre B^T
  const float* Bs = sm + I::B;
  float dpa[3] = {0.f, 0.f, 0.f}, dpb[3] = {0.f, 0.f, 0.f};
#pragma unroll
  for (int kb = 0; kb < 12; ++kb) {
#pragma unroll
    for (int j = 0; j < 2; ++j) {
      const int k = 8 * kb + 2 * t + j;
      const float b0 = Bs[k], b1 = Bs[EP + k], b2 = Bs[2 * EP + k];
      const float qa = de[kb][j] * ce[kb][2 * j];
      const float qb = de[kb][2 + j] * ce[kb][2 * j + 1];
      dpa[0] = fmaf(qa, b0, dpa[0]);
      dpa[1] = fmaf(qa, b1, dpa[1]);
      dpa[2] = fmaf(qa, b2, dpa[2]);
      dpb[0] = fmaf(qb, b0, dpb[0]);
      dpb[1] = fmaf(qb, b1, dpb[1]);
      dpb[2] = fmaf(qb, b2, dpb[2]);
      de[kb][j] = qa;
      de[kb][2 + j] = qb;
    }
  }
#pragma unroll
  for (int j = 0; j < 3; ++j) {
    dpa[j] += __shfl_xor_sync(0xffffffffu, dpa[j], 1);
    dpa[j] += __shfl_xor_sync(0xffffffffu, dpa[j], 2);
    dpb[j] += __shfl_xor_sync(0xffffffffu, dpb[j], 1);
    dpb[j] += __shfl_xor_sync(0xffffffffu, dpb[j], 2);
  }
  float* dpo = a.dp_part + (size_t)d * a.n * 3;
  if (t == 0) {
#pragma unroll
    for (int j = 0; j < 3; ++j) {
      if (va) dpo[3 * (size_t)ra + j] = dpa[j];
      if (vb) dpo[3 * (size_t)rb + j] = dpb[j];
    }
  }
  float* dco = d == 0 ? a.dcm : d == 1 ? a.dcf : a.dcc;
#pragma unroll
  for (int nb = 0; nb < 4; ++nb) {
    const int col = 8 * nb + 2 * t;
    if (va)
      *reinterpret_cast<float2*>(dco + (size_t)ra * HID + col) =
          make_float2(dc[nb][0], dc[nb][1]);
    if (vb)
      *reinterpret_cast<float2*>(dco + (size_t)rb * HID + col) =
          make_float2(dc[nb][2], dc[nb][3]);
  }

  if (LIVE) {
    // dB = p^T dpre over the tile (the e columns of X are free again)
    float* X = sm + T::X;
#pragma unroll
    for (int kb = 0; kb < 12; ++kb) {
      const int col = 8 * kb + 2 * t;
      *reinterpret_cast<float2*>(X + (lrow + g) * XS + col) =
          make_float2(de[kb][0], de[kb][1]);
      *reinterpret_cast<float2*>(X + (lrow + g + 8) * XS + col) =
          make_float2(de[kb][2], de[kb][3]);
    }
    __syncthreads();
    const float* PT = sm + T::PT;
    for (int e = tid; e < 3 * EMB; e += THREADS) {
      const int j = e / EMB, k = e - j * EMB;
      float s = 0.f;
      for (int pt = 0; pt < TPTS; ++pt)
        s = fmaf(PT[pt * PS + j], X[pt * XS + k], s);
      prow[LMid::B + e] = s;
    }
    if (tid == 0) prow[LMid::B + 3 * EMB] = 0.f;  // B's padding
  }
}

template <bool LIVE>
__global__ void __launch_bounds__(THREADS, LIVE ? 1 : 2)
nice_bwd_kernel(const BwdArgs a) {
  extern __shared__ float4 smem4[];
  float* sm = reinterpret_cast<float*>(smem4);
  const int slot = blockIdx.y;
  const int d = a.dec[slot];
  if (d == 1)
    decoder_bwd<2 * HID, LIVE>(a, slot, d, sm);
  else
    decoder_bwd<HID, LIVE>(a, slot, d, sm);
}

// wgrad[flat_off(d) + col] = sum over tiles of the partial rows, in a
// fixed order: thread (x, y) sums rows y, y + 8, ..., then row 0 of the
// block adds the eight sums in order.  blockIdx.y: the live decoder.
__global__ void __launch_bounds__(256)
nice_wgrad_reduce_kernel(const float* __restrict__ partial,
                         float* __restrict__ wgrad, int tiles,
                         const BwdArgs a) {
  __shared__ float s[8][33];
  const int d = a.dec[blockIdx.y];
  const int size = flat_size(d);
  const int col = blockIdx.x * 32 + threadIdx.x;
  float acc = 0.f;
  if (col < size) {
    const float* src = partial + a.pbase[blockIdx.y] + col;
    for (int r = threadIdx.y; r < tiles; r += 8) acc += src[(size_t)r * size];
  }
  s[threadIdx.y][threadIdx.x] = acc;
  __syncthreads();
  if (threadIdx.y == 0 && col < size) {
    float v = 0.f;
#pragma unroll
    for (int q = 0; q < 8; ++q) v += s[q][threadIdx.x];
    wgrad[flat_off(d) + col] = v;
  }
}

size_t live_smem(int d) {
  return sizeof(float) * (d == 1 ? Tiles<2 * HID>::size : Tiles<HID>::size);
}

int set_smem_limits() {
  static int done = 0;
  if (!done) {
    cudaFuncSetAttribute(nice_bwd_kernel<false>,
                         cudaFuncAttributeMaxDynamicSharedMemorySize,
                         (int)FROZEN_SMEM_MAX);
    cudaFuncSetAttribute(nice_bwd_kernel<true>,
                         cudaFuncAttributeMaxDynamicSharedMemorySize,
                         (int)LIVE_SMEM_MAX);
    done = 1;
  }
  return (int)cudaGetLastError();
}

}  // namespace

extern "C" {

// Floats in the three decoders' shared-memory images, and where each starts.
int nice_bwd_image_floats() { return IMG_TOTAL; }
int nice_bwd_image_offset(int d) { return img_off(d); }

// Points per tile; a live decoder's partial rows are ceil(n / this).
int nice_bwd_tile_points() { return TPTS; }

const char* nice_decode_error_string(int err) {
  return cudaGetErrorString((cudaError_t)err);
}

// Registers, local (spill) bytes a thread and resident blocks per SM of the
// kernel variant (live: with weight gradients) for decoder d.
int nice_bwd_variant_info(int live, int d, int* regs, int* local_bytes,
                          int* blocks_per_sm) {
  int err = set_smem_limits();
  if (err) return err;
  cudaFuncAttributes at;
  const void* fn = live ? (const void*)nice_bwd_kernel<true>
                        : (const void*)nice_bwd_kernel<false>;
  err = (int)cudaFuncGetAttributes(&at, fn);
  if (err) return err;
  *regs = at.numRegs;
  *local_bytes = (int)at.localSizeBytes;
  const size_t smem = live ? live_smem(d) : sizeof(float) * img_size(d);
  return (int)cudaOccupancyMaxActiveBlocksPerMultiprocessor(
      blocks_per_sm, fn, THREADS, smem);
}

// dp_part: [n_dec][n][3]; dcc is not written in the fine stage.  live: bit
// d set = decoder d takes weight gradients; partial: ceil(n / 64) rows per
// live decoder, in decoder order; wgrad: the packed layout, written for the
// live decoders only.
int nice_decode_bwd(const float* p, const float* cm, const float* cf,
                    const float* cc, const float* g, const float* wimg,
                    float* dp_part, float* dcm, float* dcf, float* dcc,
                    float* partial, float* wgrad, int n, int with_color,
                    int live, void* stream) {
  int err = set_smem_limits();
  if (err) return err;
  if (n <= 0) return 0;
  const cudaStream_t st = (cudaStream_t)stream;
  const int tiles = (n + TPTS - 1) / TPTS;
  const int n_dec = with_color ? 3 : 2;
  BwdArgs a = {p, cm, cf, cc, g, wimg, dp_part, dcm, dcf, dcc, partial, n,
               {0, 0, 0}, {0, 0, 0}};
  BwdArgs b = a;
  int n_frozen = 0, n_live = 0;
  size_t smem_f = 0, smem_l = 0;
  long long base = 0;
  int max_cols = 0;
  for (int d = 0; d < n_dec; ++d) {
    if ((live >> d) & 1) {
      b.dec[n_live] = d;
      b.pbase[n_live] = base;
      base += (long long)tiles * flat_size(d);
      n_live++;
      if (live_smem(d) > smem_l) smem_l = live_smem(d);
      if (flat_size(d) > max_cols) max_cols = flat_size(d);
    } else {
      a.dec[n_frozen++] = d;
      const size_t s = sizeof(float) * img_size(d);
      if (s > smem_f) smem_f = s;
    }
  }
  if (n_frozen) {
    nice_bwd_kernel<false><<<dim3(tiles, n_frozen), THREADS, smem_f, st>>>(a);
    err = (int)cudaGetLastError();
    if (err) return err;
  }
  if (n_live) {
    nice_bwd_kernel<true><<<dim3(tiles, n_live), THREADS, smem_l, st>>>(b);
    err = (int)cudaGetLastError();
    if (err) return err;
    nice_wgrad_reduce_kernel<<<dim3((max_cols + 31) / 32, n_live), dim3(32, 8),
                               0, st>>>(partial, wgrad, tiles, b);
    err = (int)cudaGetLastError();
  }
  return err;
}

}  // extern "C"
