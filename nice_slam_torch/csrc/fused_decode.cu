// Fused NICE decode, forward (K1), for Hopper (sm_90a).
//
// Replaces the Pallas TPU kernel of nice_slam_tpu/ops/pallas/fused_decode.py:
//   K1  _fwd_kernel  (launched by _fwd, fused_decode.py:170-189, 274-295)
// The backward (K2) is fused_decode_bwd.cu.
//
// Per point: e = sin(p.B) in full fp32, then three 5-block MLPs
//   h = relu(x W + b) + c V + a, skip concat x3 = [e, h2] (125 wide),
// middle on c_mid, fine on [c_fine | c_mid], colour on c_color (colour stage
// only).  Output (N, 4) = [rgb, occ_mid + occ_fine].
//
// What bounds it on the H100: the colour-stage forward is 51,653 MAC per
// point against 412 bytes of point I/O (~250 FLOP/B), so it is bound by
// fp32 arithmetic (67 TFLOP/s outside the tensor cores), not by memory.
// The design keeps every activation of a point in its own thread
// (registers and local memory) and stages one decoder's weights at a time
// in dynamic shared memory (the fine decoder is 20,924 floats, ~84 KB; all
// three would leave no room), so each multiply-add reads its weight as a
// warp-uniform shared-memory broadcast (float4 where the row allows) and
// nothing but the point rows and the output touches device memory.  The
// embedding stays fp32 (sinf, never the fast intrinsic: the arguments
// reach O(100)).
//
// Weight buffer: the packed layout of fused_decode_layout.cuh.

#include <cuda_runtime.h>

#include "fused_decode_layout.cuh"

namespace {

using namespace nice_decode;

constexpr int TP = 128;  // points per block = threads per block

constexpr size_t FWD_SMEM = sizeof(float) * WMAX;

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

int set_smem_limits() {
  static int done = 0;
  if (!done) {
    cudaFuncSetAttribute(nice_fwd_kernel,
                         cudaFuncAttributeMaxDynamicSharedMemorySize,
                         (int)FWD_SMEM);
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

}  // extern "C"
