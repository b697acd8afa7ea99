"""Where the fused-decode kernels' time goes, by ablation.

    python3 -m nice_slam_torch.tools.decode_ablation [--kernel k1|k2|both]

Builds patched copies of a kernel's sources, each without one part of the
work or with an alternative for it, and times every copy's launches (the C
entry, buffers allocated once) at the main path's shapes on one GPU.  Each
variant gets a directory of its own holding its copy of the kernel's
source and of the headers (the shared trunk csrc/fused_decode_mma.cuh and
the layout), so a patch of the shared trunk reaches that variant alone.
An ablated copy computes wrong results on purpose: the difference of its
time from the unpatched kernel's is the cost of the part it leaves out.

K1, the forward (csrc/fused_decode.cu), at 48,000 colour, 48,000 fine and
9,600 colour:

  base         the kernel as it is
  no_sincos    the embedding's sine replaced by the identity
  one_mma      1xTF32: only big*big of each 3xTF32 product
  persistent   blocks persistent over tiles, as many as are resident
               (occupancy API) shared equally among the decoders, each
               staging its image once and walking over every gridDim.x-th
               tile (a design comparison: same results)
  no_combine   without the pass that sums the occupancies

K2, the backward (csrc/fused_decode_bwd.cu), at the main path's four
shapes and 48,000 colour with all three decoders live:

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

import argparse
import ctypes
import os
import subprocess
import sys

from nice_slam_torch.ops import cuda_build
from nice_slam_torch.ops import fused_decode as fd

MMA = "fused_decode_mma.cuh"
HEADERS = (MMA, "fused_decode_layout.cuh")
INCLUDE = '#include "fused_decode_mma.cuh"\n'


def _identity_after_include(fn: str, sig: str, body: str):
    """A patch that defines an identity function after the trunk include."""
    return (None, INCLUDE, INCLUDE + f"\n__device__ __forceinline__ {sig} "
            f"{fn}(float x{body}\n")


ONE_MMA = (MMA, "  mma_tf32(d, a.lo, b0h, b1h);\n"
                "  mma_tf32(d, a.hi, b0l, b1l);\n", "")

# kernel -> (source, {variant: [(file or None for the source, old, new)]})
VARIANTS = {
    "k1": ("fused_decode.cu", {
        "base": [],
        "no_sincos": [("fused_decode.cu", "sin_fp32(fmaf", "sin_identity(fmaf"),
                      _identity_after_include("sin_identity", "float",
                                              ") {\n  return x;\n}")],
        "one_mma": [ONE_MMA],
        "persistent": [
            ("fused_decode.cu",
             "  if (row < a.n) decode_slab<C>(a, d, sm, L, row, pa, pb, cfr);",
             "  for (; row < a.n; row += gridDim.x * TPTS) {\n"
             "    decode_slab<C>(a, d, sm, L, row, pa, pb, cfr);\n"
             "    load_points<C>(a, csrc, row + gridDim.x * TPTS + g, t, pa, "
             "pb, cfr);\n  }"),
            ("fused_decode.cu",
             "  const int gx = (n + TPTS - 1) / TPTS;  // one block per tile",
             "  int dev = 0, sms = 0, per_sm = 0;\n"
             "  cudaGetDevice(&dev);\n"
             "  cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, "
             "dev);\n"
             "  cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, "
             "nice_fwd_kernel, THREADS, SMEM);\n"
             "  const int tiles = (n + TPTS - 1) / TPTS;\n"
             "  const int per_dec = (sms * per_sm + n_dec - 1) / n_dec;\n"
             "  const int gx = tiles < per_dec ? tiles : per_dec;")],
        "no_combine": [("fused_decode.cu",
                        "  nice_fwd_combine_kernel<<<", "  if (0) "
                        "nice_fwd_combine_kernel<<<")],
    }),
    "k2": ("fused_decode_bwd.cu", {
        "base": [],
        "no_sincos": [("fused_decode_bwd.cu", "sincos_fp32(fmaf",
                       "sincos_identity(fmaf"),
                      _identity_after_include(
                          "sincos_identity", "void",
                          ", float* s, float* c) {\n  *s = x;\n  *c = x;\n}")],
        "libm_sincos": [("fused_decode_bwd.cu", "sincos_fp32(fmaf",
                         "sincosf(fmaf")],
        "cvt_split_w": [(MMA, "  big = (__float_as_uint(x) + 0x1000u) & "
                              "0xffffe000u;", "  big = to_tf32(x);")],
        "one_mma": [ONE_MMA],
        "no_items": [("fused_decode_bwd.cu",
                      "wgrad_block<C>(sm, prow, i, warp, lane);", "")],
    }),
}

# K1: (points, colour stage); K2: (points, colour stage, live mask)
K1_SHAPES = ((48000, True), (48000, False), (9600, True))
K2_SHAPES = ((48000, True, 4), (48000, True, 0), (48000, False, 0),
             (9600, True, 0), (48000, True, 7))


def patched_sources(kernel: str, name: str) -> dict:
    """{file name: text} of a variant: the kernel's source and the headers,
    each patch applied to every occurrence of its target."""
    source, variants = VARIANTS[kernel]
    texts = {f: (cuda_build.CSRC / f).read_text() for f in (source,) + HEADERS}
    for target, old, new in variants[name]:
        target = target or source
        if old not in texts[target]:
            raise RuntimeError(f"{kernel} variant {name}: patch target "
                               f"missing in {target}")
        texts[target] = texts[target].replace(old, new)
    return texts


def build_variants(kernel: str, out_dir: str) -> dict:
    source, variants = VARIANTS[kernel]
    procs = {}
    for name in variants:
        vdir = os.path.join(out_dir, f"{kernel}_{name}")
        os.makedirs(vdir, exist_ok=True)
        for f, text in patched_sources(kernel, name).items():
            with open(os.path.join(vdir, f), "w") as fh:
                fh.write(text)
        cmd = ([cuda_build.nvcc_path()] + cuda_build.NVCC_FLAGS
               + ["-I", vdir, "-o", os.path.join(vdir, "lib.so"),
                  os.path.join(vdir, source)])
        procs[name] = subprocess.Popen(cmd, stdout=subprocess.PIPE,
                                       stderr=subprocess.STDOUT, text=True)
    libs = {}
    for name, proc in procs.items():
        log, _ = proc.communicate()
        if proc.returncode != 0:
            raise RuntimeError(f"nvcc failed for {kernel} variant {name}:\n"
                               f"{log}")
        lib = ctypes.CDLL(os.path.join(out_dir, f"{kernel}_{name}", "lib.so"))
        vp, ci = ctypes.c_void_p, ctypes.c_int
        if kernel == "k1":
            lib.nice_decode_fwd.restype = ci
            lib.nice_decode_fwd.argtypes = [vp] * 7 + [ci, ci, vp]
        else:
            lib.nice_decode_bwd.restype = ci
            lib.nice_decode_bwd.argtypes = [vp] * 12 + [ci] * 3 + [vp]
        libs[name] = lib
    return libs


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--kernel", choices=("k1", "k2", "both"), default="both")
    args = ap.parse_args()

    import torch

    if not torch.cuda.is_available():
        print("decode_ablation: no CUDA device", file=sys.stderr)
        return 1
    sys.path.insert(0, str(cuda_build.PKG_DIR.parent))
    import chip_smoke as cs
    from nice_slam_torch.models.decoders import ModelSpec, init_model
    from nice_slam_torch.models.pretrain import load_npz_decoders

    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True).stdout.strip())
    out_dir = str(cuda_build.BUILD_DIR / "decode_ablation")
    kernels = ("k1", "k2") if args.kernel == "both" else (args.kernel,)
    libs = {k: build_variants(k, out_dir) for k in kernels}
    dev = torch.device("cuda", 0)
    ws = [w.contiguous() for w in fd.pack_nice_weights(load_npz_decoders(
        os.path.join(cs.REPO, "pretrained", "decoders_tpu.npz"),
        init_model(torch.Generator(device=dev).manual_seed(0), ModelSpec(),
                   device=dev)))]
    img = fd.build_image(ws)
    if "k1" in libs:
        print("K1 variant  " + "  ".join(
            f"{n}/{'color' if wc else 'fine'}" for n, wc in K1_SHAPES)
            + "  (ms)")
        for name, lib in libs["k1"].items():
            row = []
            for n, wc in K1_SHAPES:
                p, cm, cf, cc, _ = cs.make_inputs(torch, n, 99, dev)
                a, out, scratch = fd._fwd_prepare(wc, p, cm, cf, cc, img)
                row.append(cs.cuda_time_ms(
                    torch, lambda: lib.nice_decode_fwd(*a)))
            print(f"{name:11s} " + "  ".join(f"{t:.4f}" for t in row),
                  flush=True)
    if "k2" in libs:
        print("K2 variant  " + "  ".join(
            f"{n}/{'color' if wc else 'fine'}/live={lv}"
            for n, wc, lv in K2_SHAPES) + "  (ms)")
        for name, lib in libs["k2"].items():
            row = []
            for n, wc, live in K2_SHAPES:
                p, cm, cf, cc, go = cs.make_inputs(torch, n, 99, dev)
                a, outs, scratch = fd._bwd_prepare(wc, live, p, cm, cf, cc,
                                                   go, img)
                row.append(cs.cuda_time_ms(
                    torch, lambda: lib.nice_decode_bwd(*a)))
            print(f"{name:11s} " + "  ".join(f"{t:.4f}" for t in row),
                  flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
