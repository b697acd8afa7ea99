// Fused NICE decode, forward (K1), for Hopper (sm_90a).
//
// Replaces the Pallas TPU kernel _fwd_kernel of
// nice_slam_tpu/ops/pallas/fused_decode.py (fused_decode.py:170-189,
// launched by _fwd at :274): per point, e = sin(p.B), then the 5-block
// middle, fine and (colour stage) colour MLPs
//   z_i = x_i W_i + b_i,  h_i = relu(z_i) + c V_i + a_i,
//   x_0 = e, x_3 = [e, h_2], x_i = h_{i-1} else,
// middle on c_mid, fine on [c_fine | c_mid], colour on c_color.  Output
// (N, 4) = [rgb, occ_mid + occ_fine]; in the fine stage rgb is zero and
// c_color is not read.  The backward (K2) is fused_decode_bwd.cu.
//
// What bounds it on the H100: the colour-stage forward is ~51,700 MAC per
// point against 412 bytes of point I/O, so it is bound by arithmetic.  Every
// product of width 32 (x W_i, c V_i) runs on the tensor cores as 3xTF32
// (fused_decode_mma.cuh: mma.sync m16n8k8 TF32, each operand split into its
// TF32 rounding and the remainder), which keeps fp32-level error at up to
// 495/3 TFLOP/s.  The embedding (p.B, K=3) and the heads (O <= 4) stay SIMT
// fp32; sin is the branch-free sin_fp32 (2 ulp, never the fast intrinsic:
// the arguments reach O(100)).
//
// Design (the trunk of K2, shared through fused_decode_mma.cuh):
// - Decoder-major grid (128-point tiles, decoders: middle, fine and in the
//   colour stage colour): a block stages its decoder's weight image
//   (Img<C>, 78 KB or 103 KB) into shared memory with cp.async, overlapped
//   with loading its points and features, while the other block of the SM
//   computes.  One block per tile and not blocks persistent over tiles:
//   the hardware's block scheduler then balances the decoders (a fine tile
//   costs ~1.3 times a middle or colour one), which a fixed share of tiles
//   per block did not, and staging the image for every tile is hidden
//   (persistent blocks were slower at 48,000 points in both stages and no
//   faster at 9,600: nice_slam_torch/tools/decode_ablation.py, variant
//   persistent).
// - A warp owns 16 points of the tile and never waits for the others:
//   after the image is staged there is no barrier.  Activations stay in
//   registers as mma accumulator fragments, each reused as the next
//   product's A operand through c_to_a.  e is computed once, one k-block
//   at a time in block 0, which takes both its products there: z_0 and the
//   e part of z_3 (z3e, 16 registers instead of e's 48).
// - Output, deterministic: the middle and fine blocks write their
//   occupancy into occ_part[0] and occ_part[1], the colour block writes
//   [rgb, 0] into out; nice_fwd_combine_kernel then writes
//   out[:, 3] = occ_part[0] + occ_part[1] (and zero rgb in the fine stage),
//   the order of the plain version.  The ragged tail is zero-padded on
//   load and masked on store.

#include <cuda_runtime.h>
#include <stdint.h>

#include "fused_decode_mma.cuh"

namespace {

using namespace nice_decode;

constexpr int WARPS = 8;
constexpr int THREADS = 32 * WARPS;
constexpr int TPTS = 16 * WARPS;  // points per tile (a warp owns 16)

// every block of a launch reserves the largest image (the fine decoder's)
constexpr size_t SMEM = sizeof(float) * Img<2 * HID>::size;

struct FwdArgs {
  const float* p;
  const float* cm;
  const float* cf;
  const float* cc;
  const float* wimg;  // the three decoders' shared-memory images
  float* occ_part;    // [2][n]: the middle and fine decoders' occupancy
  float* out;         // [n][4]
  int n;
};

// The lane's two points (rows ra, rb) and its feature A fragments (k-block
// kb: columns 8kb + 2t, 8kb + 2t + 1); the fine decoder reads
// [c_fine | c_mid].  Zeros past n.
template <int C>
__device__ __forceinline__ void load_points(const FwdArgs& a,
                                            const float* csrc, int ra, int t,
                                            float (&pa)[3], float (&pb)[3],
                                            float (&cfr)[C / 8][4]) {
  const int rb = ra + 8;
  const bool va = ra < a.n, vb = rb < a.n;
#pragma unroll
  for (int j = 0; j < 3; ++j) {
    pa[j] = va ? a.p[3 * (size_t)ra + j] : 0.f;
    pb[j] = vb ? a.p[3 * (size_t)rb + j] : 0.f;
  }
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
}

// acc = v broadcast over the lane's two rows (v: a 32-wide bias row)
__device__ __forceinline__ void bias_rows(float (&acc)[4][4], const float* v,
                                          int t) {
#pragma unroll
  for (int nb = 0; nb < 4; ++nb) {
    const int c = 8 * nb + 2 * t;
    acc[nb][0] = acc[nb][2] = v[c];
    acc[nb][1] = acc[nb][3] = v[c + 1];
  }
}

// The forward of decoder d (feature width C) for the warp's 16 points,
// from row `row` on: the lane's rows row + g and row + g + 8, its points
// pa, pb and feature fragments cfr (load_points).
template <int C>
__device__ __forceinline__ void decode_slab(const FwdArgs& a, int d,
                                            const float* sm, const Lane& L,
                                            int row, const float (&pa)[3],
                                            const float (&pb)[3],
                                            const float (&cfr)[C / 8][4]) {
  using I = Img<C>;
  const int g = L.g, t = L.t;
  const float* Bs = sm + I::B;
  // block 0 and the e part of block 3: e = sin(p.B) one k-block at a time
  float z[4][4], z3e[4][4] = {}, h[4][4];
  bias_rows(z, sm + I::b, t);
  {
    const float* W0 = sm + I::W0;
    const float* W3 = sm + I::W3;
#pragma unroll
    for (int kb = 0; kb < EP / 8; ++kb) {
      // A fragment of e: columns 8kb + 2t (+1) of the lane's two rows
      float e[4];
#pragma unroll
      for (int j = 0; j < 2; ++j) {
        const int k = 8 * kb + 2 * t + j;
        const float b0 = Bs[k], b1 = Bs[EP + k], b2 = Bs[2 * EP + k];
        e[2 * j] = sin_fp32(fmaf(pa[2], b2, fmaf(pa[1], b1, pa[0] * b0)));
        e[2 * j + 1] =
            sin_fp32(fmaf(pb[2], b2, fmaf(pb[1], b1, pb[0] * b0)));
      }
      const AFrag A = split_a(e);
#pragma unroll
      for (int nb = 0; nb < 4; ++nb) {
        const int o = L.f[nb & 1] + 8 * WS * kb + 8 * nb;
        mma3(z[nb], A, W0[o], W0[o + WS]);
        mma3(z3e[nb], A, W3[o], W3[o + WS]);
      }
    }
  }
  bias_rows(h, sm + I::a, t);
  mm_fwd<C / 8>(h, cfr, sm + I::V, L);
#pragma unroll
  for (int nb = 0; nb < 4; ++nb)
#pragma unroll
    for (int r = 0; r < 4; ++r) h[nb][r] += fmaxf(z[nb][r], 0.f);

  // blocks 1..4
#pragma unroll 1
  for (int i = 1; i < NBLK; ++i) {
    bias_rows(z, sm + I::b + i * HID, t);
    if (i == 3) {
#pragma unroll
      for (int nb = 0; nb < 4; ++nb)
#pragma unroll
        for (int r = 0; r < 4; ++r) z[nb][r] += z3e[nb][r];
    }
    float x[4][4];
    c_to_a(h, x);
    mm_fwd<4>(z, x, sm + img_w(i) + (i == 3 ? EP * WS : 0), L);
    bias_rows(h, sm + I::a + i * HID, t);
    mm_fwd<C / 8>(h, cfr, sm + I::V + i * C * WS, L);
#pragma unroll
    for (int nb = 0; nb < 4; ++nb)
#pragma unroll
      for (int r = 0; r < 4; ++r) h[nb][r] += fmaxf(z[nb][r], 0.f);
  }

  // head: out = h_4 Wo + bo (Wo zero past O): the lane's 8 columns, then
  // a butterfly over the four lanes of a row
  const float* Wo = sm + I::Wo;
  float sa[3] = {0.f, 0.f, 0.f}, sb[3] = {0.f, 0.f, 0.f};
#pragma unroll
  for (int nb = 0; nb < 4; ++nb)
#pragma unroll
    for (int j = 0; j < 2; ++j) {
      const float* w = Wo + 4 * (8 * nb + 2 * t + j);
#pragma unroll
      for (int o = 0; o < 3; ++o) {
        sa[o] = fmaf(h[nb][j], w[o], sa[o]);
        sb[o] = fmaf(h[nb][2 + j], w[o], sb[o]);
      }
    }
#pragma unroll
  for (int o = 0; o < 3; ++o) {
    sa[o] += __shfl_xor_sync(0xffffffffu, sa[o], 1);
    sa[o] += __shfl_xor_sync(0xffffffffu, sa[o], 2);
    sb[o] += __shfl_xor_sync(0xffffffffu, sb[o], 1);
    sb[o] += __shfl_xor_sync(0xffffffffu, sb[o], 2);
    sa[o] += sm[I::bo + o];
    sb[o] += sm[I::bo + o];
  }
  const int ra = row + g, rb = ra + 8;
  if (t == 0) {
    if (d == 2) {
      float4* o4 = reinterpret_cast<float4*>(a.out);
      if (ra < a.n) o4[ra] = make_float4(sa[0], sa[1], sa[2], 0.f);
      if (rb < a.n) o4[rb] = make_float4(sb[0], sb[1], sb[2], 0.f);
    } else {
      float* occ = a.occ_part + (size_t)d * a.n;
      if (ra < a.n) occ[ra] = sa[0];
      if (rb < a.n) occ[rb] = sb[0];
    }
  }
}

// The forward of decoder d (feature width C) for the block's tile.
template <int C>
__device__ __forceinline__ void decoder_fwd(const FwdArgs& a, int d,
                                            float* sm) {
  using I = Img<C>;
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const Lane L = lane_offsets(lane);
  const int g = L.g, t = L.t;
  const float* csrc = d == 0 ? a.cm : d == 1 ? a.cf : a.cc;

  // stage the image; meanwhile load the warp's points and features
  const float* wg = a.wimg + img_off(d);
  for (int q = tid; q < I::size / 4; q += THREADS)
    cp_async16(sm + 4 * q, wg + 4 * q);
  int row = blockIdx.x * TPTS + 16 * warp;  // the warp's first point
  float pa[3], pb[3];
  float cfr[C / 8][4];
  load_points<C>(a, csrc, row + g, t, pa, pb, cfr);
  cp_async_wait_all();
  __syncthreads();
  if (row < a.n) decode_slab<C>(a, d, sm, L, row, pa, pb, cfr);
}

__global__ void __launch_bounds__(THREADS, 2)
nice_fwd_kernel(const FwdArgs a) {
  extern __shared__ float4 smem4[];
  float* sm = reinterpret_cast<float*>(smem4);
  const int d = blockIdx.y;
  if (d == 1)
    decoder_fwd<2 * HID>(a, d, sm);
  else
    decoder_fwd<HID>(a, d, sm);
}

// out[:, 3] = occ_mid + occ_fine; in the fine stage also rgb = 0
__global__ void __launch_bounds__(256)
nice_fwd_combine_kernel(const float* __restrict__ occ_part,
                        float* __restrict__ out, int n, int with_color) {
  const int i = blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= n) return;
  const float occ = occ_part[i] + occ_part[(size_t)n + i];
  if (with_color)
    out[4 * (size_t)i + 3] = occ;
  else
    reinterpret_cast<float4*>(out)[i] = make_float4(0.f, 0.f, 0.f, occ);
}

constexpr int MAX_DEVICES = 64;

// The dynamic shared-memory limit is an attribute of the kernel on one
// device: set it once per device ordinal (the current device), so a
// process that launches on a second card sets it there too.
int set_smem_limit() {
  static unsigned char done[MAX_DEVICES] = {0};
  int dev = 0;
  int err = (int)cudaGetDevice(&dev);
  if (err) return err;
  if (dev < 0 || dev >= MAX_DEVICES) return (int)cudaErrorInvalidDevice;
  if (!done[dev]) {
    cudaFuncSetAttribute(nice_fwd_kernel,
                         cudaFuncAttributeMaxDynamicSharedMemorySize,
                         (int)SMEM);
    done[dev] = 1;
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

// Floats in the three decoders' shared-memory images, and where each starts.
int nice_decode_image_floats() { return IMG_TOTAL; }
int nice_decode_image_offset(int d) { return img_off(d); }

const char* nice_decode_error_string(int err) {
  return cudaGetErrorString((cudaError_t)err);
}

// Registers, local (spill) bytes a thread and resident blocks per SM of the
// forward kernel.
int nice_fwd_variant_info(int* regs, int* local_bytes, int* blocks_per_sm) {
  int err = set_smem_limit();
  if (err) return err;
  cudaFuncAttributes at;
  err = (int)cudaFuncGetAttributes(&at, nice_fwd_kernel);
  if (err) return err;
  *regs = at.numRegs;
  *local_bytes = (int)at.localSizeBytes;
  return (int)cudaOccupancyMaxActiveBlocksPerMultiprocessor(
      blocks_per_sm, nice_fwd_kernel, THREADS, SMEM);
}

// wimg: the images of nice_decode_image_offset; occ_part: [2][n] scratch;
// out: [n][4].
int nice_decode_fwd(const float* p, const float* cm, const float* cf,
                    const float* cc, const float* wimg, float* occ_part,
                    float* out, int n, int with_color, void* stream) {
  int err = set_smem_limit();
  if (err || n <= 0) return err;
  const int n_dec = with_color ? 3 : 2;
  const int gx = (n + TPTS - 1) / TPTS;  // one block per tile
  const cudaStream_t st = (cudaStream_t)stream;
  const FwdArgs a = {p, cm, cf, cc, wimg, occ_part, out, n};
  nice_fwd_kernel<<<dim3(gx, n_dec), THREADS, SMEM, st>>>(a);
  err = (int)cudaGetLastError();
  if (err) return err;
  nice_fwd_combine_kernel<<<(n + 255) / 256, 256, 0, st>>>(occ_part, out, n,
                                                           with_color);
  return (int)cudaGetLastError();
}

}  // extern "C"
