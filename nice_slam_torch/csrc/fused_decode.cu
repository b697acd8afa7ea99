// Fused NICE decode, forward (K1) and backward (K2), for Hopper (sm_90a).
//
// Replaces the Pallas TPU kernels of nice_slam_tpu/ops/pallas/fused_decode.py:
//   K1  _fwd_kernel  (launched by _fwd,      fused_decode.py:170-189, 274-295)
//   K2  _bwd_kernel  (launched by _bwd_rule, fused_decode.py:192-253, 304-342)
//
// Per point: e = sin(p.B) in full fp32, then three 5-block MLPs
//   h = relu(x W + b) + c V + a, skip concat x3 = [e, h2] (125 wide),
// middle on c_mid, fine on [c_fine | c_mid], colour on c_color (colour stage
// only).  Output (N, 4) = [rgb, occ_mid + occ_fine].
//
// What bounds it on the H100: the colour-stage forward is 51,653 MAC per
// point against 412 bytes of point I/O (~250 FLOP/B), so both directions are
// bound by fp32 arithmetic (67 TFLOP/s outside the tensor cores), not by
// memory.  The design keeps every activation of a point in its own thread
// (registers and local memory) and stages one decoder's weights at a time
// in dynamic shared memory (the fine decoder is 20,924 floats, ~84 KB; all
// three would leave no room), so each multiply-add reads its weight as a
// warp-uniform shared-memory broadcast (float4 where the row allows) and
// nothing but the point rows and the output touches device memory.  The
// embedding and its backward stay fp32 (sinf/cosf, never the fast
// intrinsics: the arguments reach O(100)).  Tensor cores (TF32/bf16 wgmma)
// are later work.
//
// Weight gradients: the TPU kernel sums them across a sequential grid into
// one output block.  GPU blocks run concurrently, so here each block reduces
// its 128 points in shared memory (per-layer [points x inputs] and
// [points x outputs] tiles, then one thread per weight element sums over the
// tile) and writes one partial row; a second kernel sums the rows in a fixed
// order.  Deterministic, no atomics.  With train_weights == 0 the tiles and
// the second kernel are skipped and the caller returns no weight gradient.
//
// Weight buffer: the 69 arrays of pack_nice_weights order, flattened into one
// fp32 buffer where every array starts on a 4-float boundary (see Layout;
// nice_slam_torch/ops/fused_decode.py builds the same layout).

#include <cuda_runtime.h>

namespace {

constexpr int HID = 32;
constexpr int EMB = 93;
constexpr int NBLK = 5;
constexpr int TP = 128;  // points per block = threads per block

// Padded per-decoder layout (offsets in floats).  C: feature width, O: head
// width.  B is (3, 93) padded to 280; bo is padded to 4.
template <int C, int O>
struct Layout {
  static constexpr int B = 0;
  static constexpr int W0 = 280;                     // (93, 32)
  static constexpr int W1 = W0 + EMB * HID;          // (32, 32)
  static constexpr int W2 = W1 + HID * HID;          // (32, 32)
  static constexpr int W3 = W2 + HID * HID;          // (125, 32)
  static constexpr int W4 = W3 + (EMB + HID) * HID;  // (32, 32)
  static constexpr int b = W4 + HID * HID;           // 5 x (32)
  static constexpr int V = b + NBLK * HID;           // 5 x (C, 32)
  static constexpr int a = V + NBLK * C * HID;       // 5 x (32)
  static constexpr int Wo = a + NBLK * HID;          // (32, O)
  static constexpr int bo = Wo + HID * O;            // (O) padded to 4
  static constexpr int size = bo + 4;
};

using LMid = Layout<HID, 1>;
using LFine = Layout<2 * HID, 1>;
using LColor = Layout<HID, 4>;

constexpr int MID_OFF = 0;
constexpr int FINE_OFF = MID_OFF + LMid::size;
constexpr int COLOR_OFF = FINE_OFF + LFine::size;
constexpr int TOTAL = COLOR_OFF + LColor::size;
constexpr int WMAX = LFine::size;  // largest decoder, floats of shared memory

// shared-memory tiles of the weight-gradient reduction (row strides chosen
// odd so per-point writes of one column hit distinct banks)
constexpr int XS = EMB + HID;  // layer inputs (<= 125), later dpre (93)
constexpr int DS = HID + 1;    // dz, head cotangent, or p
constexpr int HS = HID + 1;    // dh
constexpr int CS = 2 * HID + 1;  // point features (<= 64)
constexpr int TILE_FLOATS = TP * (XS + DS + HS + CS);

constexpr size_t FWD_SMEM = sizeof(float) * WMAX;
constexpr size_t BWD_SMEM_TRAIN = sizeof(float) * (WMAX + TILE_FLOATS);

static_assert(FINE_OFF % 4 == 0 && COLOR_OFF % 4 == 0, "float4 alignment");
static_assert(WMAX % 4 == 0, "tile alignment");
static_assert(BWD_SMEM_TRAIN <= 232448, "exceeds Hopper shared memory");

__device__ __forceinline__ int w_off(int i) {
  // offset of W_i inside a decoder (identical for every decoder)
  return i == 0 ? 280
       : i == 1 ? 280 + EMB * HID
       : i == 2 ? 280 + EMB * HID + HID * HID
       : i == 3 ? 280 + EMB * HID + 2 * HID * HID
                : 280 + EMB * HID + 2 * HID * HID + (EMB + HID) * HID;
}

// Copy one decoder's weights into shared memory (all threads take part).
__device__ __forceinline__ void stage_weights(float* sw, const float* w,
                                              int n_floats) {
  const float4* src = reinterpret_cast<const float4*>(w);
  float4* dst = reinterpret_cast<float4*>(sw);
  for (int q = threadIdx.x; q < n_floats / 4; q += blockDim.x) dst[q] = src[q];
}

// e_k = sin(p . B[:, k]) in full fp32
__device__ __forceinline__ float embed_arg(const float* B, int k, float p0,
                                           float p1, float p2) {
  return p0 * B[k] + p1 * B[EMB + k] + p2 * B[2 * EMB + k];
}

// acc[j] += x * row[j], row 16-byte aligned in shared memory
__device__ __forceinline__ void axpy32(float x, const float* row,
                                       float (&acc)[HID]) {
  const float4* r4 = reinterpret_cast<const float4*>(row);
#pragma unroll
  for (int q = 0; q < HID / 4; ++q) {
    const float4 v = r4[q];
    acc[4 * q + 0] = fmaf(x, v.x, acc[4 * q + 0]);
    acc[4 * q + 1] = fmaf(x, v.y, acc[4 * q + 1]);
    acc[4 * q + 2] = fmaf(x, v.z, acc[4 * q + 2]);
    acc[4 * q + 3] = fmaf(x, v.w, acc[4 * q + 3]);
  }
}

// sum_j d[j] * row[j]
__device__ __forceinline__ float dot32(const float (&d)[HID],
                                       const float* row) {
  const float4* r4 = reinterpret_cast<const float4*>(row);
  float s = 0.f;
#pragma unroll
  for (int q = 0; q < HID / 4; ++q) {
    const float4 v = r4[q];
    s = fmaf(d[4 * q + 0], v.x, s);
    s = fmaf(d[4 * q + 1], v.y, s);
    s = fmaf(d[4 * q + 2], v.z, s);
    s = fmaf(d[4 * q + 3], v.w, s);
  }
  return s;
}

__device__ __forceinline__ unsigned relu_bits(const float (&z)[HID]) {
  unsigned m = 0u;
#pragma unroll
  for (int j = 0; j < HID; ++j) m |= (z[j] > 0.f ? 1u : 0u) << j;
  return m;
}

// Block i of the trunk, in place on h:
//   z = x_i W_i + b_i   with x_0 = e, x_3 = [e, h_2], x_i = h_{i-1} else
//   h = relu(z) + a_i + c V_i
// Returns the relu pattern of z.  The layer index is a runtime value: one
// copy of this code serves all five blocks (the 32-wide loops unroll).
template <int C, int O>
__device__ __forceinline__ unsigned mlp_block(const float* w, int i, float p0,
                                              float p1, float p2,
                                              const float (&c)[C],
                                              float (&h)[HID]) {
  using L = Layout<C, O>;
  const float* W = w + w_off(i);
  float z[HID];
#pragma unroll
  for (int j = 0; j < HID; ++j) z[j] = w[L::b + i * HID + j];
  int k0 = 0;
  if (i == 0 || i == 3) {
    for (int k = 0; k < EMB; ++k) {
      const float e = sinf(embed_arg(w + L::B, k, p0, p1, p2));
      axpy32(e, W + k * HID, z);
    }
    k0 = EMB;
  }
  if (i != 0) {
#pragma unroll
    for (int k = 0; k < HID; ++k) axpy32(h[k], W + (k0 + k) * HID, z);
  }
  const float* a = w + L::a + i * HID;
  const float* V = w + L::V + i * C * HID;
#pragma unroll
  for (int j = 0; j < HID; ++j) h[j] = fmaxf(z[j], 0.f) + a[j];
#pragma unroll
  for (int k = 0; k < C; ++k) axpy32(c[k], V + k * HID, h);
  return relu_bits(z);
}

// The five blocks; h ends as h_4.  With Hs != nullptr, Hs[i * 32 + j]
// keeps h_i and mask[i] the relu pattern of z_i (for the backward).
template <int C, int O>
__device__ __forceinline__ void mlp_trunk(const float* w, float p0, float p1,
                                          float p2, const float (&c)[C],
                                          float (&h)[HID], float* Hs,
                                          unsigned* mask) {
#pragma unroll
  for (int j = 0; j < HID; ++j) h[j] = 0.f;
#pragma unroll 1
  for (int i = 0; i < NBLK; ++i) {
    const unsigned m = mlp_block<C, O>(w, i, p0, p1, p2, c, h);
    if (Hs != nullptr) {
      mask[i] = m;
#pragma unroll
      for (int j = 0; j < HID; ++j) Hs[i * HID + j] = h[j];
    }
  }
}

// dst[r * nb + s] = sum_t A[t * lda + r] * Bt[t * ldb + s]  over the tile's
// TP points; one thread per output element.
__device__ __forceinline__ void tile_gemm_tn(float* __restrict__ dst,
                                             const float* A, int lda, int na,
                                             const float* Bt, int ldb, int nb) {
  for (int e = threadIdx.x; e < na * nb; e += blockDim.x) {
    const int r = e / nb;
    const int s = e - r * nb;
    float acc = 0.f;
    for (int t = 0; t < TP; ++t) acc = fmaf(A[t * lda + r], Bt[t * ldb + s], acc);
    dst[e] = acc;
  }
}

// dst[s] = sum_t Bt[t * ldb + s]
__device__ __forceinline__ void tile_colsum(float* __restrict__ dst,
                                            const float* Bt, int ldb, int nb) {
  for (int s = threadIdx.x; s < nb; s += blockDim.x) {
    float acc = 0.f;
    for (int t = 0; t < TP; ++t) acc += Bt[t * ldb + s];
    dst[s] = acc;
  }
}

struct Tiles {
  float* X;   // [TP][XS]
  float* DZ;  // [TP][DS]
  float* DH;  // [TP][HS]
  float* Cf;  // [TP][CS]
};

// Hand VJP of one decoder for the calling thread's point (the transcription
// of _mlp_backward, fused_decode.py:121-164).  dout: head cotangent (O).
// Accumulates dp, writes dc.  With wg != nullptr the block also writes its
// partial weight gradients (this decoder's section of the partial row);
// then every thread of the block must call this function.
template <int C, int O>
__device__ void mlp_backward(const float* w, float* wg, const Tiles& tl,
                             float p0, float p1, float p2, const float (&c)[C],
                             const float (&dout)[O], float (&dp)[3],
                             float (&dc)[C]) {
  using L = Layout<C, O>;
  const int t = threadIdx.x;
  float H[NBLK * HID];  // h_0 .. h_4 (local memory)
  unsigned mask[NBLK];
  float dh[HID];
  mlp_trunk<C, O>(w, p0, p1, p2, c, dh, H, mask);

#pragma unroll
  for (int k = 0; k < C; ++k) dc[k] = 0.f;

  // head: out = h4 Wo + bo
#pragma unroll
  for (int k = 0; k < HID; ++k) {
    float s = 0.f;
#pragma unroll
    for (int o = 0; o < O; ++o) s = fmaf(dout[o], w[L::Wo + k * O + o], s);
    dh[k] = s;
  }
  if (wg != nullptr) {
#pragma unroll
    for (int k = 0; k < C; ++k) tl.Cf[t * CS + k] = c[k];
#pragma unroll
    for (int k = 0; k < HID; ++k) tl.X[t * XS + k] = H[4 * HID + k];
#pragma unroll
    for (int o = 0; o < O; ++o) tl.DZ[t * DS + o] = dout[o];
    __syncthreads();
    tile_gemm_tn(wg + L::Wo, tl.X, XS, HID, tl.DZ, DS, O);
    tile_colsum(wg + L::bo, tl.DZ, DS, O);
    __syncthreads();
  }

  float de[EMB];
#pragma unroll 1
  for (int i = NBLK - 1; i >= 0; --i) {
    // dc += dh V_i^T
    const float* V = w + L::V + i * C * HID;
#pragma unroll
    for (int k = 0; k < C; ++k) dc[k] += dot32(dh, V + k * HID);
    float dz[HID];
    const unsigned m = mask[i];
#pragma unroll
    for (int j = 0; j < HID; ++j) dz[j] = ((m >> j) & 1u) ? dh[j] : 0.f;

    if (wg != nullptr) {
      // the block's input x_i into the tile
      int in_dim = HID;
      if (i == 0 || i == 3) {
        for (int k = 0; k < EMB; ++k)
          tl.X[t * XS + k] = sinf(embed_arg(w + L::B, k, p0, p1, p2));
        in_dim = (i == 0) ? EMB : EMB + HID;
      }
      if (i != 0) {
        const int k0 = (i == 3) ? EMB : 0;
        const float* hin = H + (i - 1) * HID;
#pragma unroll
        for (int k = 0; k < HID; ++k) tl.X[t * XS + k0 + k] = hin[k];
      }
#pragma unroll
      for (int j = 0; j < HID; ++j) {
        tl.DZ[t * DS + j] = dz[j];
        tl.DH[t * HS + j] = dh[j];
      }
      __syncthreads();
      tile_gemm_tn(wg + w_off(i), tl.X, XS, in_dim, tl.DZ, DS, HID);
      tile_colsum(wg + L::b + i * HID, tl.DZ, DS, HID);
      tile_gemm_tn(wg + L::V + i * C * HID, tl.Cf, CS, C, tl.DH, HS, HID);
      tile_colsum(wg + L::a + i * HID, tl.DH, HS, HID);
      __syncthreads();
    }

    // cotangent of the block input: e part (blocks 0 and 3), h part
    const float* W = w + w_off(i);
    if (i == 0 || i == 3) {
      for (int k = 0; k < EMB; ++k) {
        const float v = dot32(dz, W + k * HID);
        de[k] = (i == 3) ? v : de[k] + v;
      }
    }
    if (i != 0) {
      const int k0 = (i == 3) ? EMB : 0;
      float dn[HID];
#pragma unroll
      for (int k = 0; k < HID; ++k) dn[k] = dot32(dz, W + (k0 + k) * HID);
#pragma unroll
      for (int k = 0; k < HID; ++k) dh[k] = dn[k];
    }
  }

  // embedding: dpre = de * cos(p.B); dp = dpre B^T; dB = p^T dpre
  const float* B = w + L::B;
  for (int k = 0; k < EMB; ++k) {
    const float dpre = de[k] * cosf(embed_arg(B, k, p0, p1, p2));
    dp[0] = fmaf(dpre, B[k], dp[0]);
    dp[1] = fmaf(dpre, B[EMB + k], dp[1]);
    dp[2] = fmaf(dpre, B[2 * EMB + k], dp[2]);
    if (wg != nullptr) tl.X[t * XS + k] = dpre;
  }
  if (wg != nullptr) {
    tl.DZ[t * DS + 0] = p0;
    tl.DZ[t * DS + 1] = p1;
    tl.DZ[t * DS + 2] = p2;
    __syncthreads();
    tile_gemm_tn(wg + L::B, tl.DZ, DS, 3, tl.X, XS, EMB);
    __syncthreads();
  }
}

template <int C>
__device__ __forceinline__ void load_row(const float* src, int i, bool valid,
                                         float* dst) {
  // one point's feature row (32 floats); zeros past the ragged tail
  const float4* s4 = reinterpret_cast<const float4*>(src + (size_t)i * C);
#pragma unroll
  for (int q = 0; q < C / 4; ++q) {
    const float4 v = valid ? s4[q] : make_float4(0.f, 0.f, 0.f, 0.f);
    dst[4 * q + 0] = v.x;
    dst[4 * q + 1] = v.y;
    dst[4 * q + 2] = v.z;
    dst[4 * q + 3] = v.w;
  }
}

__device__ __forceinline__ void store_row(float* dst, int i, bool valid,
                                          const float* src) {
  if (!valid) return;
  float4* d4 = reinterpret_cast<float4*>(dst + (size_t)i * HID);
#pragma unroll
  for (int q = 0; q < HID / 4; ++q)
    d4[q] = make_float4(src[4 * q], src[4 * q + 1], src[4 * q + 2],
                        src[4 * q + 3]);
}

__global__ void __launch_bounds__(TP)
nice_fwd_kernel(const float* __restrict__ p, const float* __restrict__ cm,
                const float* __restrict__ cf, const float* __restrict__ cc,
                const float* __restrict__ w, float* __restrict__ out, int n,
                int with_color) {
  extern __shared__ float4 smem4[];
  float* sw = reinterpret_cast<float*>(smem4);
  const int i = blockIdx.x * TP + threadIdx.x;
  const bool valid = i < n;
  const float p0 = valid ? p[3 * (size_t)i + 0] : 0.f;
  const float p1 = valid ? p[3 * (size_t)i + 1] : 0.f;
  const float p2 = valid ? p[3 * (size_t)i + 2] : 0.f;
  float h[HID];
  float occ = 0.f;
  float rgb[3] = {0.f, 0.f, 0.f};

  // middle decoder on c_mid
  stage_weights(sw, w + MID_OFF, LMid::size);
  __syncthreads();
  {
    float c[HID];
    load_row<HID>(cm, i, valid, c);
    mlp_trunk<HID, 1>(sw, p0, p1, p2, c, h, nullptr, nullptr);
    float s = sw[LMid::bo];
#pragma unroll
    for (int k = 0; k < HID; ++k) s = fmaf(h[k], sw[LMid::Wo + k], s);
    occ = s;
  }
  __syncthreads();

  // fine decoder on [c_fine | c_mid]
  stage_weights(sw, w + FINE_OFF, LFine::size);
  __syncthreads();
  {
    float c[2 * HID];
    load_row<HID>(cf, i, valid, c);
    load_row<HID>(cm, i, valid, c + HID);
    mlp_trunk<2 * HID, 1>(sw, p0, p1, p2, c, h, nullptr, nullptr);
    float s = sw[LFine::bo];
#pragma unroll
    for (int k = 0; k < HID; ++k) s = fmaf(h[k], sw[LFine::Wo + k], s);
    occ += s;
  }

  if (with_color) {
    __syncthreads();
    stage_weights(sw, w + COLOR_OFF, LColor::size);
    __syncthreads();
    float c[HID];
    load_row<HID>(cc, i, valid, c);
    mlp_trunk<HID, 4>(sw, p0, p1, p2, c, h, nullptr, nullptr);
#pragma unroll
    for (int o = 0; o < 3; ++o) {
      float s = sw[LColor::bo + o];
#pragma unroll
      for (int k = 0; k < HID; ++k) s = fmaf(h[k], sw[LColor::Wo + k * 4 + o], s);
      rgb[o] = s;
    }
  }
  if (valid) {
    reinterpret_cast<float4*>(out)[i] = make_float4(rgb[0], rgb[1], rgb[2], occ);
  }
}

__global__ void __launch_bounds__(TP)
nice_bwd_kernel(const float* __restrict__ p, const float* __restrict__ cm,
                const float* __restrict__ cf, const float* __restrict__ cc,
                const float* __restrict__ g, const float* __restrict__ w,
                float* __restrict__ dp_out, float* __restrict__ dcm,
                float* __restrict__ dcf, float* __restrict__ dcc,
                float* __restrict__ partial, int n, int with_color,
                int train) {
  extern __shared__ float4 smem4[];
  float* sw = reinterpret_cast<float*>(smem4);
  Tiles tl;
  tl.X = sw + WMAX;
  tl.DZ = tl.X + TP * XS;
  tl.DH = tl.DZ + TP * DS;
  tl.Cf = tl.DH + TP * HS;
  float* row = train ? partial + (size_t)blockIdx.x * TOTAL : nullptr;

  const int i = blockIdx.x * TP + threadIdx.x;
  const bool valid = i < n;
  const float p0 = valid ? p[3 * (size_t)i + 0] : 0.f;
  const float p1 = valid ? p[3 * (size_t)i + 1] : 0.f;
  const float p2 = valid ? p[3 * (size_t)i + 2] : 0.f;
  const float4 gi = valid ? reinterpret_cast<const float4*>(g)[i]
                          : make_float4(0.f, 0.f, 0.f, 0.f);
  float dp[3] = {0.f, 0.f, 0.f};

  // middle decoder: occupancy cotangent
  stage_weights(sw, w + MID_OFF, LMid::size);
  __syncthreads();
  {
    float c[HID], dc[HID];
    const float dout[1] = {gi.w};
    load_row<HID>(cm, i, valid, c);
    mlp_backward<HID, 1>(sw, row ? row + MID_OFF : nullptr, tl, p0, p1, p2, c,
                         dout, dp, dc);
    store_row(dcm, i, valid, dc);
  }
  __syncthreads();

  // fine decoder; the c_mid half of its input is stop-gradient: dropped
  stage_weights(sw, w + FINE_OFF, LFine::size);
  __syncthreads();
  {
    float c[2 * HID], dc[2 * HID];
    const float dout[1] = {gi.w};
    load_row<HID>(cf, i, valid, c);
    load_row<HID>(cm, i, valid, c + HID);
    mlp_backward<2 * HID, 1>(sw, row ? row + FINE_OFF : nullptr, tl, p0, p1,
                             p2, c, dout, dp, dc);
    store_row(dcf, i, valid, dc);
  }

  if (with_color) {
    // colour head: rgb cotangent only (its occupancy output is discarded)
    __syncthreads();
    stage_weights(sw, w + COLOR_OFF, LColor::size);
    __syncthreads();
    float c[HID], dc[HID];
    const float dout[4] = {gi.x, gi.y, gi.z, 0.f};
    load_row<HID>(cc, i, valid, c);
    mlp_backward<HID, 4>(sw, row ? row + COLOR_OFF : nullptr, tl, p0, p1, p2,
                         c, dout, dp, dc);
    store_row(dcc, i, valid, dc);
  } else if (valid) {
    float4* d4 = reinterpret_cast<float4*>(dcc + (size_t)i * HID);
#pragma unroll
    for (int q = 0; q < HID / 4; ++q) d4[q] = make_float4(0.f, 0.f, 0.f, 0.f);
  }
  if (valid) {
    dp_out[3 * (size_t)i + 0] = dp[0];
    dp_out[3 * (size_t)i + 1] = dp[1];
    dp_out[3 * (size_t)i + 2] = dp[2];
  }
}

// wgrad[col] = sum over rows of partial[row * TOTAL + col], rows in order
__global__ void nice_wgrad_reduce_kernel(const float* __restrict__ partial,
                                         float* __restrict__ wgrad, int rows,
                                         int cols) {
  const int col = blockIdx.x * blockDim.x + threadIdx.x;
  if (col >= cols) return;
  float acc = 0.f;
  for (int r = 0; r < rows; ++r) acc += partial[(size_t)r * TOTAL + col];
  wgrad[col] = acc;
}

int set_smem_limits() {
  static int done = 0;
  if (!done) {
    cudaFuncSetAttribute(nice_fwd_kernel,
                         cudaFuncAttributeMaxDynamicSharedMemorySize,
                         (int)FWD_SMEM);
    cudaFuncSetAttribute(nice_bwd_kernel,
                         cudaFuncAttributeMaxDynamicSharedMemorySize,
                         (int)BWD_SMEM_TRAIN);
    done = 1;
  }
  return (int)cudaGetLastError();
}

}  // namespace

extern "C" {

// Floats in the packed weight buffer (and in the weight-gradient buffer).
int nice_decode_weight_floats() { return TOTAL; }

// Offsets of the three decoders inside the packed buffer.
int nice_decode_decoder_offset(int d) {
  return d == 0 ? MID_OFF : d == 1 ? FINE_OFF : COLOR_OFF;
}

// Points per block; the backward's partial buffer has ceil(n / this) rows.
int nice_decode_tile_points() { return TP; }

const char* nice_decode_error_string(int err) {
  return cudaGetErrorString((cudaError_t)err);
}

int nice_decode_fwd(const float* p, const float* cm, const float* cf,
                    const float* cc, const float* w, float* out, int n,
                    int with_color, void* stream) {
  int err = set_smem_limits();
  if (err) return err;
  if (n <= 0) return 0;
  const int blocks = (n + TP - 1) / TP;
  nice_fwd_kernel<<<blocks, TP, FWD_SMEM, (cudaStream_t)stream>>>(
      p, cm, cf, cc, w, out, n, with_color);
  return (int)cudaGetLastError();
}

int nice_decode_bwd(const float* p, const float* cm, const float* cf,
                    const float* cc, const float* g, const float* w,
                    float* dp, float* dcm, float* dcf, float* dcc,
                    float* partial, float* wgrad, int n, int with_color,
                    int train, void* stream) {
  int err = set_smem_limits();
  if (err) return err;
  if (n <= 0) return 0;
  const int blocks = (n + TP - 1) / TP;
  const size_t smem = train ? BWD_SMEM_TRAIN : FWD_SMEM;
  nice_bwd_kernel<<<blocks, TP, smem, (cudaStream_t)stream>>>(
      p, cm, cf, cc, g, w, dp, dcm, dcf, dcc, partial, n, with_color, train);
  err = (int)cudaGetLastError();
  if (err || !train) return err;
  const int cols = with_color ? TOTAL : COLOR_OFF;
  nice_wgrad_reduce_kernel<<<(cols + 255) / 256, 256, 0,
                             (cudaStream_t)stream>>>(partial, wgrad, blocks,
                                                     cols);
  return (int)cudaGetLastError();
}

}  // extern "C"
