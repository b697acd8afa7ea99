"""Where the fused-decode backward kernel (K2) spends its time, by ablation.

    python3 -m nice_slam_torch.tools.k2_ablation

Builds patched copies of csrc/fused_decode_bwd.cu, each without one part
of the work or with an alternative for it, and times every copy's
launches (the C entry, buffers allocated once) at the main path's shapes
on one GPU.  An ablated copy computes wrong results on purpose: the
difference of its time from the unpatched kernel's is the cost of the
part it leaves out.  Variants:

  base         the kernel as it is
  no_sincos    the embedding's sin/cos replaced by the identity
  libm_sincos  the library's sincosf in place of sincos_fp32 (a design
               comparison: same results to 2 ulp)
  cvt_split_w  the weights' TF32 rounding by cvt.rna in place of the
               integer add-and-mask (a design comparison: same results)
  one_mma      1xTF32: only big*big of each 3xTF32 product
  no_items     no weight-gradient tile products (live decoders)

Prints the card (nvidia-smi name and power limit) and one line a variant.
"""

from __future__ import annotations

import ctypes
import os
import subprocess
import sys

from nice_slam_torch.ops import cuda_build
from nice_slam_torch.ops import fused_decode as fd

VARIANTS = {
    "base": [],
    "no_sincos": [
        ("sincos_fp32(fmaf", "sincos_identity(fmaf"),
        ("// 3xTF32 on the tensor cores",
         "__device__ __forceinline__ void sincos_identity(float x, float* s,"
         " float* c) {\n  *s = x;\n  *c = x;\n}\n\n"
         "// 3xTF32 on the tensor cores")],
    "libm_sincos": [("sincos_fp32(fmaf", "sincosf(fmaf")],
    "cvt_split_w": [("  big = (__float_as_uint(x) + 0x1000u) & 0xffffe000u;",
                     "  big = to_tf32(x);")],
    "one_mma": [("  mma_tf32(d, a.lo, b0h, b1h);\n"
                 "  mma_tf32(d, a.hi, b0l, b1l);\n", "")],
    "no_items": [("wgrad_block<C>(sm, prow, i, warp, lane);", "")],
}

# (points, colour stage, live mask): the main path's four shapes and the
# shape with all three decoders live
SHAPES = ((48000, True, 4), (48000, True, 0), (48000, False, 0),
          (9600, True, 0), (48000, True, 7))


def build_variants(out_dir: str) -> dict:
    src = open(cuda_build.CSRC / "fused_decode_bwd.cu").read()
    procs = {}
    for name, patches in VARIANTS.items():
        text = src
        for old, new in patches:
            if old not in text:
                raise RuntimeError(f"variant {name}: patch target missing")
            text = text.replace(old, new)
        cu = os.path.join(out_dir, f"k2_{name}.cu")
        with open(cu, "w") as f:
            f.write(text)
        cmd = ([cuda_build.nvcc_path()] + cuda_build.NVCC_FLAGS
               + ["-I", str(cuda_build.CSRC), "-o",
                  os.path.join(out_dir, f"k2_{name}.so"), cu])
        procs[name] = subprocess.Popen(cmd, stdout=subprocess.PIPE,
                                       stderr=subprocess.STDOUT, text=True)
    libs = {}
    for name, proc in procs.items():
        log, _ = proc.communicate()
        if proc.returncode != 0:
            raise RuntimeError(f"nvcc failed for variant {name}:\n{log}")
        lib = ctypes.CDLL(os.path.join(out_dir, f"k2_{name}.so"))
        lib.nice_decode_bwd.restype = ctypes.c_int
        lib.nice_decode_bwd.argtypes = ([ctypes.c_void_p] * 12
                                        + [ctypes.c_int] * 3
                                        + [ctypes.c_void_p])
        libs[name] = lib
    return libs


def main() -> int:
    import torch

    if not torch.cuda.is_available():
        print("k2_ablation: no CUDA device", file=sys.stderr)
        return 1
    sys.path.insert(0, str(cuda_build.PKG_DIR.parent))
    import chip_smoke as cs
    from nice_slam_torch.models.decoders import ModelSpec, init_model
    from nice_slam_torch.models.pretrain import load_npz_decoders

    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True).stdout.strip())
    out_dir = str(cuda_build.BUILD_DIR / "k2_ablation")
    os.makedirs(out_dir, exist_ok=True)
    libs = build_variants(out_dir)
    dev = torch.device("cuda", 0)
    ws = [w.contiguous() for w in fd.pack_nice_weights(load_npz_decoders(
        os.path.join(cs.REPO, "pretrained", "decoders_tpu.npz"),
        init_model(torch.Generator(device=dev).manual_seed(0), ModelSpec(),
                   device=dev)))]
    flat = fd.pack_flat(ws)
    fd._bwd_kernels()
    print("variant    " + "  ".join(
        f"{n}/{'color' if wc else 'fine'}/live={lv}" for n, wc, lv in SHAPES)
        + "  (ms)")
    for name, lib in libs.items():
        row = []
        for n, wc, live in SHAPES:
            p, cm, cf, cc, go = cs.make_inputs(torch, n, 99, dev)
            args, outs, scratch = fd._bwd_prepare(wc, live, p, cm, cf, cc,
                                                  go, flat)
            row.append(cs.cuda_time_ms(
                torch, lambda: lib.nice_decode_bwd(*args)))
        print(f"{name:10s} " + "  ".join(f"{t:.4f}" for t in row),
              flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
