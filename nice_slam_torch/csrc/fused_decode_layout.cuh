// The packed weight buffer of the fused NICE decode, shared by the forward
// (fused_decode.cu) and the backward (fused_decode_bwd.cu).
//
// The 69 arrays of pack_nice_weights order, flattened into one fp32 buffer
// where every array starts on a 4-float boundary
// (nice_slam_torch/ops/fused_decode.py weight_offsets() builds the same
// layout).  The backward's weight gradients come back in this layout too.

#pragma once

namespace nice_decode {

constexpr int HID = 32;
constexpr int EMB = 93;
constexpr int NBLK = 5;

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
constexpr int WMAX = LFine::size;  // largest decoder, floats

static_assert(FINE_OFF % 4 == 0 && COLOR_OFF % 4 == 0, "float4 alignment");
static_assert(WMAX % 4 == 0, "tile alignment");

}  // namespace nice_decode
