#!/usr/bin/env python3
"""Smoke test of the PyTorch port (nice_slam_torch) on one NVIDIA GPU.

    python3 chip_smoke.py

1. Prints the card's name and power limit (nvidia-smi) and builds every
   CUDA kernel from nice_slam_torch/csrc (one nvcc per source, together).
2. Kernel phase: the fused decode forward (K1) and backward (K2) against
   their plain PyTorch versions on the card, at N = 9,600 (tracking),
   48,000 (mapping) and 700 (ragged), in the fine and colour stages, with
   weight gradients for no decoder, for the colour decoder (the main
   path's colour stage) and for all three (the live masks, set by which
   weights require a gradient; frozen decoders must get None).
   Tolerances: forward max abs err
   <= 1e-4 * max(1, max|ref|); dp and dc elementwise rtol 1e-3, atol 1e-4
   against autograd of the plain version, where a missing point is
   accepted only if one of its ReLU pre-activations lies within 1e-4 of
   zero (a ReLU that flips between the two summation orders), and at most
   max(2, N/1000) such points; weight gradients per array cosine > 0.9999
   and norm ratio within 1e-3 (summation order over 48k points), taken
   with the cotangent of the points that have a pre-activation within
   1e-4 of zero set to zero in both runs (one flipped ReLU moves a whole
   sum).  The reported max_abs_err of K2 is over the other points.
   Then the new paths' shapes: K1 at the occupancy proxy's node count
   (fine, the refresh), K1 and K2 at 4,096 fine with the middle and fine
   decoders live (pretraining), at 96,000 colour without weight
   gradients (the colour refinement's Gauss-Newton) and at 240,000
   points (ScanNet's 5,000 mapping pixels x 48 samples: colour with the
   colour decoder live, colour and fine with none live).
   Also prints K1's and each K2 variant's registers, spill bytes and
   resident blocks per SM (CUDA runtime).
3. Main path: SlamEngine on configs/Synthetic/synthetic.yaml at its full
   width (240x320, tracking 200 px x 50 iters, mapping 1000 px x 60 iters,
   iters_first 500, 32+16 samples, hidden 32, c_dim 32, coarse mapper on)
   for 11 frames (synthetic.n_frames: 11, so frame 10 is the last frame
   and its colour refinement runs).  Decoders come from the repository's
   pretrained/decoders_tpu.npz as the config says; the grids are random
   from the config's seed.  Fails unless the kernel launch counts match
   the schedule (K1 also by kind: stage and points), the ATE is finite
   and under 0.25 m and stats() holds one record of finite tracking
   losses per tracked frame.  Prints fault 3's counters of the run (as
   phases 16 and 20 do): Python GC seconds and collections
   (gc.callbacks), the caching allocator's num_alloc_retries and
   num_device_alloc over the run and its segments at the end, and the
   host RSS.  Every NICE path of the smoke replays its tracking and
   mapping iterations as CUDA graphs (nice_slam_torch/graphs.py); each
   phase that drives an engine prints its graphs, replays, eager steps,
   capture seconds and the graph pools' MiB beside its peak.
4. Profile: utils/profiling.torch_trace (torch.profiler, Chrome trace
   written to output/chip_smoke_profile/trace.json) over one more tracked
   frame and mapping event of the trained engine, through the engine's
   graphed path, gives the device busy share and the top kernels; then
   the same frame and event again with the graphs off (eager) for the
   eager busy share.
5. Timing phase: K1 at the main path's three shapes (48,000 colour,
   48,000 fine, 9,600 colour); K2 at the main path's four shapes (48,000
   colour with the colour decoder live; 48,000 colour, 48,000 fine and
   9,600 colour without weight gradients) and at 48,000 colour with all
   three decoders live (the shape timed before K2's redesign).  Each
   kernel's launches alone (its C entry, buffers allocated once) and its
   wrapper as the autograd Function calls it, with CUDA events, beside
   its plain version and two bounds: fp32 (all operations at the CUDA
   cores' 67 TFLOP/s) and the design's own (products of width 32 on the
   tensor cores at 495/3 TFLOP/s for 3xTF32, the rest at 67 TFLOP/s);
   each bound is the larger of operations and bytes.  There is no single PyTorch call that
   computes the fused decode, so library_ms is null.  After phase 14,
   the same for the new paths' shapes (phase 2's last list).
6. Loose: the main path's config with sync_method loose (lag 2), 11
   frames and mapping.ckpt_freq 5: events 0, then 5 (fired after tracking
   frame 7), then the final event 10.  Fails unless each event fires at
   its schedule's tracker position, K1/K2 launch as the schedule says and
   the ATE is finite and under 0.35 m (the JAX package's bound for a
   lagged run).
7. Free: the same with sync_method free (lag 5) and 12 frames: events 0,
   5 (after tracking frame 10) and the final event 11.
8. Resume: a fresh engine resumes from the loose run's ckpts/00005.npz;
   right after resume its params, grids, trajectory, keyframe store and
   keyframe ids must equal the file's arrays bit for bit; it then runs to
   frame 10 (frames_done 11, launches as the schedule from the resume
   point, ATE finite and under 0.35 m).
9. iMAP*: load_config(synthetic.yaml, nice=False) with scale 1.0 and 5
   frames, at iMAP*'s full width (one 256-wide, 4-block MLP, 32 + 12
   samples per ray; tracking 200 px x 50 iters, mapping 1000 px x 60
   iters as 3 passes of 20, iters_first 500, so StepLR's steps 200 and
   400 fall inside the first event).  Fails unless K1 and K2 never launch
   (iMAP* decodes in plain fp32 torch.matmul), the ATE is finite and
   under 0.5 m and the run replayed graphs of its tracking, init_select
   and middle, fine and colour steps (phases 12, 13 and 20 hold their
   runs to their signatures the same way, and each prints its graphs,
   replays, eager steps and signatures).
10. Mesh (run right after phase 3, on its trained engine):
   utils/mesher.engine_mesher_hook at the config's meshing.resolution
   (256): the occupancy of 256^3 points in chunks of 65,536 through K1
   (fine stage), the seen mask, the host marching tetrahedra (C++, built
   with g++), the hull and component cleaning, the vertex colours through
   K1 (colour stage) and the PLY file.  Fails unless mesh/final_mesh.ply
   holds V > 0 vertices and T > 0 triangles in the padded mesh bound, K1
   launched 256 times in the fine stage at 65,536 points and
   ceil(V / 65,536) times in the colour stage, K2 never, and the colours
   read back.  Prints the wall time of each part, the peak device memory,
   V, T and K1's launches by kind; K1 is timed at the mesh's shapes as in
   phase 5.
11. Repeat: the strict path at full width for 6 frames (events 0 and 5)
   three times in one process, from the same seed: graphed, eager (the
   engine's graph runners with capture off), graphed.  The trajectories,
   the four grids, the decoders, the keyframe stores and the tracking
   losses must be bit-equal (the grid backward sums in a fixed order; a
   replay draws what the eager call drew), and the launches equal the
   schedule in each.  Prints the three walls and ATEs, and the grid
   backward's scatter
   (ops/grid.scatter_rows: sort, segment sum) timed against the
   index_add_ it replaced, at the mapping shape (48,000 points x 8
   corners into the middle and fine grids).
12. Gauss-Newton with local BA: strict, 13 frames, mapping.every_frame
   and keyframe_every 2, tracking.pose_GN_iters 2 (1,000 rays) and
   mapping.pose_GN_iters 2 (200 rays per window frame).  Local BA runs
   once more than four keyframes exist: at event 10 and in the five
   passes of the colour refinement at 12.  Fails unless BA ran at those
   events, the launches equal the schedule (each GN iteration adds K1 x2,
   K2 x1: the Jacobian's forward and backward and the candidate's SSE),
   the ATE is finite and under 0.25 m, and at the first tracked frame H
   and b through the kernels match the plain route's (reverse mode
   through reference_nice_decode) on the card: relative Frobenius error
   <= 1e-3 over the rays whose Jacobian rows agree, at most
   max(2, rays / 1000) rows differing by a ReLU flip.  Every GN
   iteration is a graph of the signature "gn" on each side; prints the
   share of GN steps the guard accepted (from the runner's accept
   buffer) and GN's share of track and map time (each GN step timed
   between two synchronisations).
13. Occupancy-guided: strict, 11 frames, rendering.occupancy_guided.
   Fails unless the proxy is refreshed after each NICE mapping pass (7:
   events 0 and 5 and the refinement's five passes; min < 0.5 after the
   first), K1 launches once at the proxy's node count (fine) per refresh,
   the ATE is finite and under 0.3 m (the JAX package's bound for this
   mode; the strict ATE of phase 3 printed beside it), and the grids,
   occ_proxy among them, are bit-equal after a save and a load into a
   fresh engine.
14. Pretraining: pretrain_decoders_synthetic on the card, 100 steps of
   4,096 points: fails unless K1 and K2 launch once per step (fine stage,
   weight gradients), only the middle and fine decoders change and the
   last loss is below the first.  Then nice_slam_torch/tools/
   pretrain_decoders.py for 3 scenes x 80 steps at 8,192 points into
   output/chip_smoke_pretrain/decoders.npz; a fresh strict engine must
   read that file's arrays exactly, and a reference-format coarse.pt /
   middle_fine.pt pair built from them must load onto the card equal.
   Prints ms per step.
15. Data-parallel: two ranks on cuda:0 over gloo through run_torch.py's
   local launch (tpu.data_parallel, mesh_shape [2]), strict, full width
   (1,000 px a rank, so 2,000 a mapping step), 6 frames (events 0 and 5).
   Fails unless the ranks' trajectories, grids and decoders are bit-equal
   (digests in their summaries), each rank's K1/K2 launches equal the
   single-rank schedule, the ATE is finite and under 0.25 m, only
   rank 0 wrote ckpts/ and each rank's mapping runner replayed segments
   with no eager step but one warm-up a segment signature (the DP step
   and its GN polish are segmented CUDA graphs around the all_reduces).
   Prints each rank's wall, map seconds, all_reduce seconds and their
   share of map time.  Then one mapping call (middle, fine and colour
   iterations, BA and a Gauss-Newton iteration) on given pixels by two
   ranks (this script started with --dp-rank) against this process on
   the union: every iteration's all-reduced loss and gradients, the
   Gauss-Newton system, the updated decoders, grids and cameras within a
   relative Frobenius error of 1e-5, the GN guard's sums (taken at the
   candidate cameras, which carry the solve's rounding) within 1e-4 (one
   GN iteration: see dp_setup).  Each rank runs that call eagerly, then
   graphed, and a longer one (DP_LONG: 10 iterations a stage on drawn
   pixels, 2 GN iterations) eagerly with the sync-debug sweep over every
   segment signature's second iteration (phase 24's, wrapping the
   segments only, never the gloo call), then graphed: fails unless each
   pair is bit-equal (every reduced sum, leaf, the cameras, the losses)
   and the sweep finds no host read.  Prints the all_reduce's bytes per
   iteration by stage, its share of map time, the backend and each
   rank's seconds eager and graphed.
16. Pipelined: parallel/pipelined.py's engine on one card, 16 frames
   (events 0, 5, 10, 15; events 5 and 10 run while frames 6-10 and 11-15
   are tracked), run twice: the mapper on its own thread and CUDA stream
   (MapperThread), then the sequential order of the same steps
   (InlineMapper: each event runs where the loop hands it over).  Both
   runs cut mapping.iters_first to 200 and turn color_refine off (event
   0 and the last event; neither overlaps tracking).  Fails unless, in
   each run, the tracked frames, hand-overs and snapshots come in the
   JAX package's pipelined order (one event of lag) with every snapshot
   after the join of its event, the launches equal the schedule, the ATE
   is finite and under 0.35 m (the JAX package's bound for a lagged run)
   and, at every event, the tracker's snapshot and trajectory share no
   storage with the mapper's map, trajectory and keyframe store; and
   unless the two runs' trajectories, decoders, grids, keyframe stores
   and checkpoints are bit-equal.  Prints both walls and their ratio, the
   host track and map seconds, the overlap share (track + map - wall) /
   min(track, map), the peak MiB and fault 3's counters.  Both sides
   replay CUDA graphs (each side its runner, pool and generator).
17. Reconstruction evaluation (host only): phase 10's final_mesh.ply
   against the synthetic scene's ground-truth mesh (its room, spheres and
   box through the port's marching tetrahedra at 2 cm, a fixture of the
   smoke) culled with phase 3's GT trajectory by nice_slam_torch/tools/
   cull_mesh.py: accuracy, completion and completion ratio at 200,000
   samples and depth L1 over 50 views (the reference's 1,000 cut to 50
   for time).  Fails unless every metric is finite, the GT mesh scored
   against itself gives a depth L1 of 0 and an accuracy and completion
   under twice the sampling floor, and the rasterizer's library equals
   its numpy oracle on one view (10,000 of the reconstruction's
   triangles: coverage within max(2, covered / 1000) pixels, depth within
   1e-4 relative).  Prints each part's wall time.
18. Grid-sharded union check: four ranks at tpu.grid_sharded [2, 2] on
   cuda:0 over gloo (this script started with --gs-rank), one mapping
   call of phase 15's window and pixels (middle, fine and colour
   iterations at the strict shapes, 1,000 px a data rank; no Gauss-Newton,
   which the gs step does not run) against this process on the union (2 x
   1,000 px) through the dense map_optimize.  Fails unless the features
   summed over the model ranks from the slabs equal the dense
   trilinear_interp bit for bit (at the query's points), every loss is
   within 1e-6 relative, the
   updated decoders, grids and cameras within 1e-5 relative Frobenius,
   the halo invariant holds bit for bit after every step, each rank's
   K1/K2 launches equal the dense call's and the ranks end bit-equal.
   Before the call, each rank's sharded query (gs_eval_points, 65,536
   points, colour) must lie within 1e-4 x max(1, max |dense|) of
   eval_points.  As in phase 15, each rank runs the call eagerly then
   graphed, and a longer one under the sync-debug sweep then graphed
   (the gs step: five or six segments an iteration around its
   collectives): each pair bit-equal in every collective's sum (a
   digest), leaf, the cameras, the losses, the launches and the halo
   checks.  Prints the collectives' bytes per iteration by kind and
   stage and each rank's seconds eager and graphed.
19. Grid-sharded engine: run_torch.py's local launch with tpu.grid_sharded
   [1, 2] (two ranks on cuda:0 over gloo), strict, full width, 6 frames:
   the checks of phase 15's run (ranks bit-equal, K1/K2 a rank = the
   single-rank schedule, ATE finite and under 0.25 m, only rank 0 wrote
   ckpts/, the mapping runners' eager steps only the warm-ups); prints
   the ATE beside phase 3's, the collectives' bytes per
   iteration by kind (features, points, halo, reassembly, data) and
   stage, their seconds and share of map time, the peak MiB a rank and
   the wall.  The kernels' per-device shared-memory attribute and device
   guard (a launch on a second card) are not exercised: one card.
20. Visualiser and replay: the main path's run (phase 3's config and
   seed, 11 frames) with enable_visualizer() at tracking and mapping
   vis_freq 5, vis_inside_freq 25: frames 5 and 10 draw tracking
   iterations 0 and 25 of 50, event 5 draws mapping iterations 0, 25 and
   50 of 60 (event 0 is the first and event 10 the colour refinement:
   none).  Each panel is a 240x320 render through K1 in 16,384-ray
   chunks (4 launches at 786,432 colour points and one at 540,672).
   Fails unless the panel files are exactly those 4 + 3 npz (and their
   jpgs if and only if matplotlib imports), the trajectory, grids and
   decoders are bit-equal to phase 3's (its digest taken before phase 4),
   K1's launches equal the schedule plus 5 a panel (K2's the schedule),
   and one tracking and one mapping panel re-rendered from their captured
   inputs through K1 equal their npz depth and match the same render
   through the plain decode within 1e-4 x max(1, max |ref|) at all but
   max(2, H*W / 1000) pixels.  K1 is checked and timed (as in phase 5) at
   the panels' two shapes.  Then nice_slam_torch/tools/replay.py --html
   on phase 3's output in a subprocess: exit 0, DATA's n and kf equal to
   phase 3's frames and keyframes, est equal to the latest checkpoint's
   est_c2w as float32, mesh arrays present as phase 10's final_mesh.ply
   is.  Prints the ms per panel (host, 'vis' stage), the wall with panels
   and without (the wall less the 'vis' stage; phase 3's beside it: the
   run without panels is not repeated, since the digest check and phase
   11 already hold it to phase 3's), the peak MiB and fault 3's
   counters.
21. Replica room0: a fixture in Replica's file layout written by the
   port's own writers (utils/imageio.py: results/frame%06d.jpg,
   results/depth%06d.png at png_depth_scale 6553.5, traj.txt) at
   Replica's 680x1200 camera, rendered from a room inside room0's bound;
   then configs/Replica/room0.yaml, unchanged, through run_torch.py's
   command line and config path with only --input_folder, --output and
   --frames 6 (mapping events 0 and 5, iters_first 1500).  First the
   committed tests/data/codec_420_61x45.jpg must decode to the sha256 of
   cv2.imread's pixels.  Fails unless the reader gives 6 frames with
   transfer_color_uint8 (colour crosses to the card as uint8), the
   launches equal the schedule (K1 also by kind) and the ATE is finite.
   Prints wall, frames/s, track / map / io / ckpt seconds, ATE, peak MiB,
   the launches by kind, ms a frame to decode (JPEG + PNG) and to read,
   and the bytes uploaded a frame as uint8 and as f32 colour; where cv2
   imports (nothing here needs it), how many of the fixture's files the
   port decodes as cv2.imread does (printed, not a gate).
22. ScanNet scene0000: the same over a ScanNet-layout fixture
   (frames/color/N.jpg, frames/depth/N.png at 1000, frames/pose/N.txt) at
   scannet.yaml's 480x640 camera and configs/ScanNet/scene0000.yaml,
   unchanged: mapping at 5,000 pixels, so K1 and K2 run at 240,000
   points.  After it K1 and K2 are timed (as in phase 5) at 240,000.
23. Graphs at reduced depth (run right after phase 11): strict, full
   width, 13 frames, tracking 5 iterations, mapping 15, iters_first 30,
   mapping.every_frame and keyframe_every 2, the coarse mapper and the
   colour refinement on, so local BA runs at events 10 and 12: every
   signature the engine captures (tracking; middle, fine, colour, colour
   with BA, the coarse mapper, the refinement with BA).  Graphed, then
   eager: fails unless the two runs are bit-equal (trajectory, decoders,
   grids, keyframes, tracking losses), the launches equal the schedule in
   both and BA ran at its events.  Prints the signatures captured by
   side and stage, the seconds spent capturing and both walls.
24. The other modes' graphs at reduced depth (run right after phase 23):
   iMAP* (4 frames, iters_first 210, so StepLR's step 200 falls inside
   one call; iters 30, tracking 10), occupancy-guided (6 frames: events 0
   and 5, the proxy refreshed six times; iters 15, iters_first 30,
   tracking 5) and GN + BA (phase 12's cadence at phase 23's depth, BA
   at events 10 and 12), each eager, then graphed.  In the eager run the
   second iteration of each signature (the one a graphed run captures;
   the first, its warm-up, makes the constants) runs under
   torch.cuda.set_sync_debug_mode("error"): the sweep for host reads a
   capture would refuse; it must cover every signature captured.  Fails unless the two runs are bit-equal
   (trajectory, decoders, grids with the proxy, keyframes, tracking
   losses), the launches equal the schedule in both (K1 also by kind)
   and the graphed run captured each of its signatures.  Prints both
   walls and the signatures checked.

Phases 6-9, 11-16, 19-24 each run in a device memory freed of the
earlier phases' engines and print their wall time, frames/s, ATE, peak
device memory and launch counts.

The smoke's whole wall (the kernels' build included) comes before the
card's name and power limit.  The last two lines are a JSON object of
the kernels and the contract line
{"ok": true, "device": {...}}.  Any failed phase exits non-zero.
"""

from __future__ import annotations

import argparse
import gc
import json
import math
import os
import statistics
import subprocess
import sys
import time

# published peaks of the H100 SXM (NVIDIA data sheet): fp32 outside the
# tensor cores, TF32 on the tensor cores (dense) and HBM3 bandwidth
PEAK_FP32_FLOPS = 67e12
PEAK_TF32_FLOPS = 495e12
PEAK_BYTES = 3.35e12

REPO = os.path.dirname(os.path.abspath(__file__))
SYN_CFG = os.path.join(REPO, "configs", "Synthetic", "synthetic.yaml")


class SmokeFailure(Exception):
    pass


def fail_if(cond: bool, msg: str):
    if cond:
        raise SmokeFailure(msg)


# ---------------------------------------------------------------------------
# Work and bytes of the fused decode, from its shapes

HID, EMB = 32, 93
LAYER_IN = [EMB, HID, HID, HID + EMB, HID]
DEC_C = {"middle": 32, "fine": 64, "color": 32}
DEC_O = {"middle": 1, "fine": 1, "color": 4}


DECS = ("middle", "fine", "color")


def _n_weights(dec: str) -> int:
    c, o = DEC_C[dec], DEC_O[dec]
    return (3 * EMB + sum(n * HID for n in LAYER_IN) + 5 * HID
            + 5 * c * HID + 5 * HID + HID * o + o)


def _macs(dec: str, direction: str, live: bool):
    """(tensor-core MAC, SIMT MAC) per point of one decoder.  Products of
    width 32 (x W_i, c V_i; dz W_i^T, dh V_i^T; x_i^T dz, c^T dh) are the
    tensor-core share; the embedding (p B, dpre B^T, p^T dpre) and the
    heads are SIMT.  The backward recomputes the forward, takes dc only for
    the first 32 feature columns (the fine decoder's c_mid half is
    stop-gradient) and the weight-gradient products only when live."""
    c, o = DEC_C[dec], DEC_O[dec]
    trunk = sum(n * HID for n in LAYER_IN)
    tc = trunk + 5 * c * HID
    simt = 3 * EMB + HID * o
    if direction == "bwd":
        tc, simt = tc + trunk + 5 * HID * HID, simt + 3 * EMB + HID * o
        if live:
            tc += trunk + 5 * c * HID
            simt += 3 * EMB + HID * o
    return tc, simt


def decode_work(n: int, with_color: bool, direction: str, live: int = 0):
    """(tensor-core flops, SIMT flops, bytes) of one call on n points;
    live: bit d set = decoder d takes weight gradients."""
    decs = DECS[:3 if with_color else 2]
    tc = simt = 0
    for d, name in enumerate(decs):
        t, s_ = _macs(name, direction, bool(live >> d & 1))
        tc, simt = tc + t, simt + s_
    wbytes = 4 * sum(_n_weights(d) for d in decs)
    n_c = len(decs)
    if direction == "fwd":
        nbytes = n * 4 * (3 + HID * n_c + 4) + wbytes
    else:
        gbytes = 4 * sum(_n_weights(d) for k, d in enumerate(decs)
                         if live >> k & 1)
        nbytes = (n * 4 * (3 + HID * n_c + 4)          # p, c, g in
                  + n * 4 * (3 + HID * n_c)            # dp, dc out
                  + wbytes + gbytes)                   # weights in, grads out
    return 2 * tc * n, 2 * simt * n, nbytes


def bound_ms(tc_flops: float, simt_flops: float, nbytes: float,
             tensor_cores: bool = False):
    """(ms, 'operations' | 'bytes'): fp32 on the CUDA cores, or with
    tensor_cores the width-32 products at the 3xTF32 rate."""
    t_ops = ((tc_flops / (PEAK_TF32_FLOPS / 3) if tensor_cores
              else tc_flops / PEAK_FP32_FLOPS)
             + simt_flops / PEAK_FP32_FLOPS) * 1e3
    t_bytes = nbytes / PEAK_BYTES * 1e3
    return (max(t_ops, t_bytes), "operations" if t_ops >= t_bytes
            else "bytes")


# ---------------------------------------------------------------------------
# Phase 2: kernels against the plain version

def make_inputs(torch, n: int, seed: int, dev):
    g = torch.Generator(device="cpu").manual_seed(seed)
    # points inside the synthetic scene's bound, features at the scale
    # of trained grids
    p = torch.rand(n, 3, generator=g) * 5.0 - 0.5
    cm = torch.randn(n, HID, generator=g) * 0.1
    cf = torch.randn(n, HID, generator=g) * 0.1
    cc = torch.randn(n, HID, generator=g) * 0.1
    go = torch.randn(n, 4, generator=g)
    return [t.to(dev).contiguous() for t in (p, cm, cf, cc, go)]


def relu_margin(torch, fd, with_color, p, cm, cf, cc, ws):
    """Per point, the smallest |pre-activation| over its decoders' units."""
    from nice_slam_torch.ops.fused_decode import _mlp_forward, _unpack

    mins = []
    cfull = torch.cat([cf, cm], dim=-1)
    for d, c in ((0, cm), (1, cfull)) + (((2, cc),) if with_color else ()):
        _, (_, _, zs, _) = _mlp_forward(p, c, *_unpack(ws, d), save=True)
        mins.append(torch.stack([z.abs().amin(dim=1) for z in zs]).amin(0))
    return torch.stack(mins).amin(0)


def check_fwd(torch, fd, ws, n, with_color, inputs):
    """K1 through its wrapper against the plain version on the same
    inputs (p, c_mid, c_fine, c_color); returns the max abs error."""
    p, cm, cf, cc = inputs
    cc_in = cc if with_color else cm
    with torch.no_grad():
        out = fd.fused_nice_decode(with_color, False, p, cm, cf, cc_in, *ws)
        torch.cuda.synchronize()
        ref = fd.reference_nice_decode(with_color, p, cm, cf, cc_in, *ws)
    e = float((out - ref).abs().max())
    tol = 1e-4 * max(1.0, float(ref.abs().max()))
    fail_if(not math.isfinite(e) or e > tol,
            f"K1 n={n} {'color' if with_color else 'fine'}: max abs err "
            f"{e} > {tol}")
    return e


LIVE_SETS = (("none", 0), ("color", 4), ("all", 7))
CHECK_N = (9600, 48000, 700)


def check_case(torch, fd, ws, dev, log, n, with_color, live_name, live,
               seed, bwd=True):
    """K1 (and with bwd K2) on one shape and live set against the plain
    version; returns (max abs err of K1, of K2 on the steady points)."""
    stage = "color" if with_color else "fine"
    train = live != 0
    p, cm, cf, cc, go = make_inputs(torch, n, seed, dev)
    cc_in = cc if with_color else cm
    err_f = check_fwd(torch, fd, ws, n, with_color, (p, cm, cf, cc))
    err_b = 0.0
    if not bwd:
        log(f"kernel check n={n} stage={stage}: ok (fwd err {err_f:.3g})")
        return err_f, err_b

    # backward through the wrapper (kernel) and autograd of the oracle;
    # decoder d's weights require a gradient when bit d of `live` is set
    def grads(fn, cot):
        xs = [t.clone().requires_grad_(True) for t in (p, cm, cf, cc_in)]
        wr = [w.clone().requires_grad_(
            bool(live >> (k // fd.N_PER_DEC) & 1))
            for k, w in enumerate(ws)]
        o = fn(with_color, xs[0], xs[1], xs[2], xs[3], wr)
        want = xs + [w for w in wr if w.requires_grad]
        got = list(torch.autograd.grad((o * cot).sum(), want,
                                       allow_unused=True))
        return got[:4] + [got.pop(4) if w.requires_grad else None
                          for w in wr]

    def kern(c, a, b, d, e_, w):
        return fd.fused_nice_decode(c, train, a, b, d, e_, *w)

    def plain(c, a, b, d, e_, w):
        return fd.reference_nice_decode(c, a, b, d, e_, *w)

    with torch.no_grad():
        # points with every ReLU pre-activation >= 1e-4 from 0
        steady = relu_margin(torch, fd, with_color, p, cm, cf, cc,
                             ws) >= 1e-4
    gk = grads(kern, go)
    torch.cuda.synchronize()
    gr = grads(plain, go)
    names = ["dp", "dc_mid", "dc_fine"] + (["dc_color"] if with_color
                                           else [])
    for k, name in enumerate(names):
        a, b = gk[k], gr[k]
        err_b = max(err_b, float((a - b)[steady].abs().max()))
        bad = ~torch.isclose(a, b, rtol=1e-3, atol=1e-4)
        rows = bad.any(dim=1).nonzero().flatten()
        if rows.numel() == 0:
            continue
        unexplained = int(steady[rows].sum())
        fail_if(unexplained > 0 or rows.numel() > max(2, n // 1000),
                f"K2 n={n} {stage} live={live_name}: {name} misses at "
                f"{rows.numel()} points ({unexplained} without a ReLU near "
                f"zero), max abs err {float((a - b).abs().max())}")
        log(f"  K2 n={n} {stage} {name}: {rows.numel()} points differ by "
            "a ReLU flip (pre-activation < 1e-4)")
    for k in range(len(ws)):
        if not live >> (k // fd.N_PER_DEC) & 1:
            fail_if(gk[4 + k] is not None,
                    f"K2 n={n} {stage} live={live_name}: frozen weight {k} "
                    "got a gradient")
    if train:
        # weight gradients sum over all points, so a flipped ReLU moves
        # whole sums: compare them on the points whose pre-activations all
        # lie >= 1e-4 from zero (the others' cotangent zeroed in both runs)
        go_s = go * steady[:, None]
        gk = grads(kern, go_s)
        torch.cuda.synchronize()
        gr = grads(plain, go_s)
        for k in range(len(ws)):
            if not live >> (k // fd.N_PER_DEC) & 1:
                continue
            a, b = gk[4 + k], gr[4 + k]
            b = torch.zeros_like(ws[k]) if b is None else b
            a = torch.zeros_like(ws[k]) if a is None else a
            nb, na = float(b.norm()), float(a.norm())
            if nb == 0.0:
                fail_if(na != 0.0, f"K2 n={n} {stage}: weight grad {k} "
                        f"should be 0, norm {na}")
                continue
            cos = float((a * b).sum()) / max(na * nb, 1e-30)
            fail_if(cos <= 0.9999 or abs(na / nb - 1) > 1e-3,
                    f"K2 n={n} {stage} live={live_name}: weight grad {k} "
                    f"cosine {cos} norm ratio {na / nb}")
    log(f"kernel check n={n} stage={stage} live={live_name}: ok "
        f"(fwd err {err_f:.3g}, bwd err {err_b:.3g})")
    return err_f, err_b


def check_kernels(torch, fd, ws, dev, log, extra=()):
    """Every shape of CHECK_N in both stages with every live set of
    LIVE_SETS, then the `extra` cases (n, with_color, live name, live,
    bwd).  Returns (max abs err of K1, max abs err of K2)."""
    cases = [(n, stage == "color", live_name, live, True)
             for n in CHECK_N for stage in ("fine", "color")
             for live_name, live in LIVE_SETS] + list(extra)
    err_f = err_b = 0.0
    for seed, case in enumerate(cases, start=1):
        n, with_color, live_name, live, bwd = case
        ef, eb = check_case(torch, fd, ws, dev, log, n, with_color,
                            live_name, live, seed, bwd)
        err_f, err_b = max(err_f, ef), max(err_b, eb)
    return err_f, err_b


# ---------------------------------------------------------------------------
# Phase 3: the main path

def map_events(n_img: int, every: int, lag: int, start: int = 0):
    """The frames mapped from frame `start` on, by the per-frame rule of
    the reference schedule: frame 0 first; while tracking idx, the frame
    idx - lag when it lies on the every_frame cadence; the final frame
    maps itself (and wins over a lagged event there)."""
    events = [0] if start == 0 else []
    for idx in range(max(start, 1), n_img):
        if idx == n_img - 1:
            events.append(idx)
        elif idx - lag > 0 and (idx - lag) % every == 0:
            events.append(idx - lag)
    return events


def expected_launches(cfg, n_img: int, events=None, tracked=None):
    """Fused-decode launches of a schedule over n_img frames: every
    fine/colour-stage iteration of the mapping events `events` (forward +
    backward; frame 0's is the first event, the last frame's the colour
    refinement), every tracking iteration of the frames `tracked`
    (forward + backward) and the two init_select renders of each tracked
    frame from the third on (forward, at the tracking shape).  Defaults:
    the strict schedule from frame 0.  Returns (K1 launches, K2 launches,
    K1 launches by 'stage n=points')."""
    m, t, r = cfg["mapping"], cfg["tracking"], cfg["rendering"]
    per_ray = r["N_samples"] + r["N_surface"]
    if events is None:
        events = map_events(n_img, m["every_frame"], 0)
    if tracked is None:
        tracked = range(1, n_img)

    def stage_iters(n, mid, fine):
        """(fine-stage, colour-stage) iterations of a mapping event"""
        n_mid = min(int(n * mid) + 1, n)
        n_fine = max(min(int(n * fine) + 1, n) - n_mid, 0)
        return n_fine, n - n_mid - n_fine

    ratios = (m["middle_iter_ratio"], m["fine_iter_ratio"])
    iters = []
    for idx in events:
        if idx == 0:
            iters.append(stage_iters(m["iters_first"], *ratios))
        elif idx == n_img - 1 and m["color_refine"]:
            fine, color = stage_iters(m["iters"], 0.0, 0.0)
            iters.append((5 * fine, 5 * color))
        else:
            iters.append(stage_iters(m["iters"], *ratios))
    track_fwd = track_bwd = 0
    for idx in tracked:
        track_fwd += t["iters"]
        track_bwd += t["iters"]
        if t["const_speed_assumption"] and t["init_select"] and idx >= 2:
            track_fwd += 2
    fine = sum(e[0] for e in iters)
    color = sum(e[1] for e in iters)
    n_map, n_track = m["pixels"] * per_ray, t["pixels"] * per_ray
    kinds = {}
    for key, count in ((f"color n={n_map}", color), (f"fine n={n_map}", fine),
                       (f"color n={n_track}", track_fwd)):
        if count:
            kinds[key] = kinds.get(key, 0) + count
    return track_fwd + fine + color, track_bwd + fine + color, kinds


def run_main_path(torch, fd, log):
    from nice_slam_torch.config import load_config
    from nice_slam_torch.engine import SlamEngine

    n_frames = 11
    cfg = load_config(SYN_CFG, overrides={
        "synthetic": {"n_frames": n_frames},
        "data": {"output": os.path.join(REPO, "output", "chip_smoke")}})
    eng = SlamEngine(cfg, device="cuda")
    # the dataset renders frames on the host: render them before timing
    for i in range(n_frames):
        eng.dataset[i]
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    fd.reset_launch_counts()
    with RunCounters(torch) as rc:
        t0 = time.perf_counter()
        eng.run()
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
    counts = fd.launch_counts()
    fwd_kinds = fd.fwd_launch_kinds()
    kinds = fd.bwd_launch_kinds()
    peak = torch.cuda.max_memory_allocated()
    ate = eng.ate()["rmse"]
    exp_f, exp_b, exp_fk = expected_launches(cfg, n_frames)
    log(f"main path: {n_frames} frames in {wall:.3f} s = "
        f"{n_frames / wall:.4f} frames/s, ATE rmse {ate:.5f} m, peak "
        f"device memory {peak / 2**20:.1f} MiB, timings {eng.timings}")
    log(f"main path fault 3 counters: {rc.result}")
    log(f"main path CUDA graphs: {graph_info(eng)} (peak "
        f"{peak / 2**20:.1f} MiB); by side {eng.graph_stats()}")
    log(f"main path launches: K1 {counts['fused_decode_fwd']} (schedule "
        f"{exp_f}), K2 {counts['fused_decode_bwd']} (schedule {exp_b}); K1 "
        f"by kind {fwd_kinds} (schedule {exp_fk}); K2 by kind {kinds}")
    fail_if(counts["fused_decode_fwd"] == 0 or counts["fused_decode_bwd"] == 0,
            "a kernel of the main path was never launched")
    fail_if(counts["fused_decode_fwd"] != exp_f
            or counts["fused_decode_bwd"] != exp_b or fwd_kinds != exp_fk,
            "launch counts differ from the schedule")
    fail_if(not math.isfinite(ate) or ate > 0.25,
            f"ATE {ate} not finite or above 0.25 m")
    recs = eng.stats()
    log(f"main path stats(): {len(recs)} records, first {recs[:1]}, last "
        f"{recs[-1:]}")
    fail_if([r["idx"] for r in recs] != list(range(1, n_frames)),
            "stats(): not one record per tracked frame")
    fail_if(not all(math.isfinite(r[k]) for r in recs
                    for k in ("first_loss", "last_loss", "best_loss")),
            "stats(): a tracking loss is not finite")
    return counts, fwd_kinds, kinds, eng, ate, wall


def profile_window(torch, eng, log):
    """Device busy share of the main path's work, read with torch.profiler
    over one tracked frame and one mapping event of the trained engine
    (the last frame again), through the engine's graphed path (every
    iteration a replay), then with the graphs off.  The profiler adds
    host time, so the idle share it gives is an upper bound."""
    from torch.autograd import DeviceType

    from nice_slam_torch.utils.profiling import torch_trace

    s = eng.specs
    idx = eng.n_img - 1
    color, depth, gt_pose = eng._load_frame(idx)
    shares = {}
    for name in ("graphed", "eager"):
        if name == "eager":
            eager_engine(eng)
        logdir = os.path.join(REPO, "output", f"chip_smoke_profile_{name}")
        torch.cuda.synchronize()
        with torch_trace(logdir) as prof:
            t0 = time.perf_counter()
            eng.track(idx, color, depth, gt_pose)
            eng._map(idx, color, depth, s.mapper, eng.iters, eng.lr_factor,
                     False, record=False)
            torch.cuda.synchronize()
            wall = time.perf_counter() - t0
        trace = os.path.join(logdir, "trace.json")
        fail_if(not os.path.exists(trace), f"profile: {trace} not written")
        log(f"profile ({name}): torch_trace wrote {trace} "
            f"({os.path.getsize(trace) / 2**20:.1f} MiB)")
        # kernel rows only: an operator's row repeats its kernels' time
        rows = [(e.key, e.self_device_time_total, e.count)
                for e in prof.key_averages()
                if e.device_type == DeviceType.CUDA
                and e.self_device_time_total > 0]
        dev_s = sum(r[1] for r in rows) / 1e6
        if dev_s == 0.0:
            log(f"profile ({name}): the profiler recorded no device time; "
                "device busy share not measured")
            continue
        shares[name] = dev_s / wall
        log(f"profile ({name}; one tracked frame + one mapping event, "
            f"profiler on): wall {wall:.4f} s, device kernel time "
            f"{dev_s:.4f} s, busy share {dev_s / wall:.4f}, idle share <= "
            f"{1 - dev_s / wall:.4f}")
        for key, us, count in sorted(rows, key=lambda r: -r[1])[:8]:
            log(f"  {us / 1e3:10.3f} ms  {count:6d} x  {key[:90]}")
    return shares


# ---------------------------------------------------------------------------
# Phases 6-9: loose, free, resume, iMAP*

def _release(torch):
    """Free the engines of earlier phases (their recorders hold them in
    reference cycles), the cuBLAS workspaces (one a stream that ran a
    product: each graph runner's side stream adds one, and PyTorch keeps
    them for the process) and the allocator's cached blocks, so that the
    next phase's peak device memory is its own."""
    gc.collect()
    torch.cuda.synchronize()
    torch._C._cuda_clearCublasWorkspaces()
    torch.cuda.empty_cache()


def graph_info(eng) -> dict:
    """The engine's CUDA-graph runners (tracking and mapping, both
    sides): graphs captured, replays, eager steps and capture seconds, and
    their memory pools' MiB."""
    runners = (eng._track_graphs, eng._map_graphs)
    out = {k: sum(r.stats()[k] for r in runners)
           for k in ("graphs", "replays", "eager_steps", "capture_s")}
    out["pool_mib"] = sum(r.pool_bytes() for r in runners) / 2**20
    return out


def eager_engine(eng):
    """The engine with its CUDA graphs off: runners that run every
    iteration eagerly (the eager runs of phases 4, 11 and 23)."""
    from nice_slam_torch.graphs import StepGraphs

    eng._track_graphs = StepGraphs(eng._track_graphs.device, capture=False)
    eng._map_graphs = StepGraphs(eng._map_graphs.device, capture=False,
                                 max_iters=eng._map_graphs.max_iters)
    return eng


def signatures(eng) -> dict:
    """The step signatures each side of `eng` captured, by name: "track",
    "init_select" and "gn", or the mapping stage."""
    return {side: sorted({k[2] if k[0] == "map" else k[0] for k in
                          getattr(eng, f"_{side}_graphs")._graphs})
            for side in ("track", "map")}


def check_graphed(log, name: str, eng, res, want: dict) -> dict:
    """Print a graphed run's graphs, replays, eager steps and signatures;
    fail unless it captured graphs and every signature of `want` ({side:
    names})."""
    g, sig = res["graphs"], signatures(eng)
    log(f"{name}: graphs {g['graphs']}, replays {g['replays']}, eager "
        f"steps {g['eager_steps']}, signatures {sig}, pools "
        f"{g['pool_mib']:.1f} MiB")
    missing = {s: sorted(set(n) - set(sig[s])) for s, n in want.items()}
    fail_if(g["graphs"] == 0 or g["replays"] == 0
            or any(missing.values()),
            f"{name}: not graphed: {g['graphs']} graphs, signatures "
            f"{sig}, missing {missing}")
    return sig


def sync_check_runner(graphs):
    """A runner like `graphs` with capture off (an eager run) whose second
    iteration of each signature (the one a graphed run captures; the
    first is its warm-up, which makes the constants) runs under
    torch.cuda.set_sync_debug_mode("error"): a host read inside a step,
    which a capture would refuse, raises there naming its op.  Each
    segment of a segmented step is a signature of its own; the host calls
    between segments (the gloo collectives, which copy through the host by
    design) run outside the check.  Its `checked` lists the signatures so
    checked."""
    import torch

    from nice_slam_torch.graphs import StepGraphs

    class SyncChecked(StepGraphs):
        def step(self, key, fn, generators=()):
            return super().step(key, lambda: self._checked(key, fn),
                                generators)

        def step_segments(self, key, segments, between, generators=()):
            segments = [lambda sk=(*key, ("segment", i)), fn=fn:
                        self._checked(sk, fn)
                        for i, fn in enumerate(segments)]
            return super().step_segments(key, segments, between,
                                         generators)

        def _checked(self, key, fn):
            if key in self.checked:
                return fn()
            if key not in self.seen:
                self.seen.append(key)
                return fn()
            self.checked.append(key)
            if self.device.type != "cuda":
                return fn()
            torch.cuda.set_sync_debug_mode("error")
            try:
                return fn()
            finally:
                torch.cuda.set_sync_debug_mode(0)

    out = SyncChecked(graphs.device, capture=False,
                      max_iters=graphs.max_iters)
    out.seen, out.checked = [], []
    return out


class RunCounters:
    """Fault 3's counters over one run: Python's garbage collector
    (seconds and collections, from gc.callbacks), the caching allocator
    (torch.cuda.memory_stats: num_alloc_retries and num_device_alloc over
    the run, segments at its end) and the host's resident set size at its
    end.  `result` holds them after the block."""

    def __init__(self, torch):
        self.torch = torch
        self.result = None

    def _gc(self, phase, info):
        if phase == "start":
            self._t = time.perf_counter()
        elif self._t is not None:
            self._gc_s += time.perf_counter() - self._t
            self._gc_n += 1
            self._t = None

    def __enter__(self):
        self._gc_s, self._gc_n, self._t = 0.0, 0, None
        self._m0 = self.torch.cuda.memory_stats()
        gc.callbacks.append(self._gc)
        return self

    def __exit__(self, *exc):
        gc.callbacks.remove(self._gc)
        m0, m1 = self._m0, self.torch.cuda.memory_stats()

        def delta(key):
            return (m1[key] - m0.get(key, 0)) if key in m1 else None

        with open("/proc/self/statm") as f:
            rss = int(f.read().split()[1]) * os.sysconf("SC_PAGE_SIZE")
        self.result = {"gc_s": self._gc_s, "gc_collections": self._gc_n,
                       "alloc_retries": delta("num_alloc_retries"),
                       "device_allocs": delta("num_device_alloc"),
                       "segments": m1.get("segment.all.current"),
                       "host_rss_mib": rss / 2**20}
        return False


def _drive(torch, fd, eng, log, name, n_frames, first_frame=0):
    """Run `eng` to n_frames with the launch counts set to 0 just before
    and read just after; record, at each mapping event, the last frame
    this run has tracked (frame 0 counts as tracked when the run starts
    there).  Returns the path's result dict."""
    events = []
    tracked = [0 if first_frame == 0 else None]
    orig_map, orig_track = eng.mapping_event, eng.track

    def track(idx, *a, **k):
        orig_track(idx, *a, **k)
        tracked[0] = idx

    def mapping_event(idx, *a, **k):
        events.append((idx, tracked[0]))
        return orig_map(idx, *a, **k)

    eng.track, eng.mapping_event = track, mapping_event
    for i in range(first_frame, n_frames):
        eng.dataset[i]   # the dataset renders frames on the host
    _release(torch)
    torch.cuda.reset_peak_memory_stats()
    # what is still allocated when the run starts (this engine's state and
    # what earlier phases hold): part of the peak, not of the run
    held = torch.cuda.memory_allocated() / 2**20
    fd.reset_launch_counts()
    t0 = time.perf_counter()
    eng.run(n_frames)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    counts = fd.launch_counts()
    res = {"path": name, "wall_s": wall,
           "frames": n_frames - first_frame,
           "frames_per_s": (n_frames - first_frame) / wall,
           "ate_rmse_m": eng.ate()["rmse"],
           "peak_mib": torch.cuda.max_memory_allocated() / 2**20,
           "held_mib": held,
           "k1": counts["fused_decode_fwd"], "k2": counts["fused_decode_bwd"],
           "events": events, "timings": dict(eng.timings),
           "graphs": graph_info(eng)}
    log(f"{name}: " + ", ".join(f"{k} {v}" for k, v in res.items()))
    return res


def _check_lagged(cfg, res, n_frames, lag, first_frame, max_ate):
    m = cfg["mapping"]
    want = map_events(n_frames, m["every_frame"], lag, first_frame)
    # the tracker's frame when each event fires: frame 0 at the first
    # event, the last frame at the final one, else the event's frame + lag
    pos = [(i, 0 if i == 0 and first_frame == 0 else
            n_frames - 1 if i == n_frames - 1 else i + lag) for i in want]
    fail_if(res["events"] != pos,
            f"{res['path']}: events (frame, tracker at) {res['events']}, "
            f"schedule {pos}")
    exp_f, exp_b, _ = expected_launches(
        cfg, n_frames, events=want,
        tracked=range(max(first_frame, 1), n_frames))
    fail_if(res["k1"] == 0 or res["k2"] == 0,
            f"{res['path']}: a kernel of the path was never launched")
    fail_if((res["k1"], res["k2"]) != (exp_f, exp_b),
            f"{res['path']}: launches K1 {res['k1']} K2 {res['k2']}, "
            f"schedule {exp_f} {exp_b}")
    ate = res["ate_rmse_m"]
    fail_if(not math.isfinite(ate) or ate > max_ate,
            f"{res['path']}: ATE {ate} not finite or above {max_ate} m")


def run_lagged(torch, fd, log, sync, n_frames):
    from nice_slam_torch.config import load_config
    from nice_slam_torch.engine import SlamEngine

    cfg = load_config(SYN_CFG, overrides={
        "sync_method": sync, "synthetic": {"n_frames": n_frames},
        "mapping": {"ckpt_freq": 5},
        "data": {"output": os.path.join(REPO, "output",
                                        f"chip_smoke_{sync}")}})
    eng = SlamEngine(cfg, device="cuda")
    res = _drive(torch, fd, eng, log, sync, n_frames)
    _check_lagged(cfg, res, n_frames, eng.map_lag, 0, 0.35)
    return res, cfg


def run_resume(torch, fd, log, cfg, n_frames):
    """Resume a fresh engine from the loose run's checkpoint of frame 5:
    the state must equal the file's arrays bit for bit; then run on."""
    import numpy as np

    from nice_slam_torch.engine import SlamEngine
    from nice_slam_torch.utils.checkpoint import _flatten, store_arrays

    ck = os.path.join(cfg["data"]["output"], "ckpts", "00005.npz")
    eng = SlamEngine(cfg, device="cuda").resume(ck)
    with np.load(ck) as z:
        saved = {k: z[k] for k in z.files}
    now = {"est_c2w": eng.est_c2w,
           "extra/kf_frame_ids": np.asarray(eng.kf_frame_ids, np.int64)}
    _flatten(eng.map_state.params, "params", now)
    _flatten(eng.map_state.grids, "grids", now)
    _flatten(store_arrays(eng.store), "keyframes", now)
    fail_if(not set(now) <= set(saved), "resume: keys missing from the file")
    differ = [k for k in now if now[k].dtype != saved[k].dtype
              or not np.array_equal(now[k], saved[k])]
    fail_if(bool(differ), f"resume: state differs from the file at {differ}")
    log(f"resume: {len(now)} arrays equal the file bit for bit; "
        f"frames_done {eng.frames_done}")
    start = eng.frames_done
    res = _drive(torch, fd, eng, log, "resume", n_frames, first_frame=start)
    fail_if(eng.frames_done != n_frames,
            f"resume: frames_done {eng.frames_done}, want {n_frames}")
    _check_lagged(cfg, res, n_frames, eng.map_lag, start, 0.35)
    return res


# The paths of phases 9, 12, 13 and 20 (load_config's nice, frames,
# overrides of the synthetic config), and the depth phase 24 cuts them to
# (frames, overrides): iMAP*'s first event keeps more than 200
# iterations, so StepLR's first step falls inside one call.
PATHS = {
    "imap": (False, 5, {"scale": 1.0}),
    "gn": (True, 13, {"mapping": {"every_frame": 2, "keyframe_every": 2,
                                  "pose_GN_iters": 2},
                      "tracking": {"pose_GN_iters": 2}}),
    "occ": (True, 11, {"rendering": {"occupancy_guided": True}}),
    "vis": (True, 11, {"tracking": {"vis_freq": 5, "vis_inside_freq": 25},
                       "mapping": {"vis_freq": 5, "vis_inside_freq": 25}}),
}
REDUCED = {
    "imap": (4, {"mapping": {"iters_first": 210, "iters": 30},
                 "tracking": {"iters": 10}}),
    "gn": (13, {"mapping": {"iters": 15, "iters_first": 30},
                "tracking": {"iters": 5}}),
    "occ": (6, {"mapping": {"iters": 15, "iters_first": 30},
                "tracking": {"iters": 5}}),
}
# the signatures each path's graphed run must capture, by side
PATH_SIGS = {
    "imap": {"track": ["track", "init_select"],
             "map": ["middle", "fine", "color"]},
    "gn": {"track": ["track", "init_select", "gn"],
           "map": ["middle", "fine", "color", "coarse", "gn"]},
    "occ": {"track": ["track", "init_select"],
            "map": ["middle", "fine", "color", "coarse"]},
    "vis": {"track": ["track", "init_select"],
            "map": ["middle", "fine", "color", "coarse"]},
}


def path_cfg(name: str, reduced: bool = False, tag: str = ""):
    """(config, frames) of a path at its phase's depth or reduced; its
    output under output/chip_smoke_<name>[_reduced][_<tag>]."""
    from nice_slam_torch.config import load_config, update_recursive

    nice, n_frames, over = PATHS[name]
    over = json.loads(json.dumps(over))
    if reduced:
        n_frames, cut = REDUCED[name]
        update_recursive(over, json.loads(json.dumps(cut)))
    sub = "_".join(x for x in (f"chip_smoke_{name}",
                               "reduced" if reduced else "", tag) if x)
    over.update(synthetic={"n_frames": n_frames},
                data={"output": os.path.join(REPO, "output", sub)})
    return load_config(SYN_CFG, nice=nice, overrides=over), n_frames


def run_imap(torch, fd, log):
    from nice_slam_torch.engine import SlamEngine

    cfg, n_frames = path_cfg("imap")
    eng = SlamEngine(cfg, device="cuda")
    res = _drive(torch, fd, eng, log, "imap", n_frames)
    res["signatures"] = check_graphed(log, "imap", eng, res,
                                      PATH_SIGS["imap"])
    fail_if(res["k1"] != 0 or res["k2"] != 0,
            f"imap: the fused decode launched ({res['k1']}, {res['k2']})")
    fail_if(eng.frames_done != n_frames, "imap: frames_done")
    ate = res["ate_rmse_m"]
    fail_if(not math.isfinite(ate) or ate > 0.5,
            f"imap: ATE {ate} not finite or above 0.5 m")
    return res


# ---------------------------------------------------------------------------
# Phases 10-11: mesh, repeat

def run_mesh(torch, fd, eng, log):
    """engine_mesher_hook on the trained main-path engine; returns the
    mesh phase's result dict."""
    import numpy as np

    from nice_slam_torch.utils.mesher import engine_mesher_hook
    from nice_slam_torch.utils.plyio import read_ply

    res_m = eng.cfg["meshing"]["resolution"]
    chunk = 65536
    before = dict(eng.timings)
    _release(torch)
    torch.cuda.reset_peak_memory_stats()
    fd.reset_launch_counts()
    t0 = time.perf_counter()
    engine_mesher_hook(eng, eng.n_img - 1, True)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    counts = fd.launch_counts()
    kinds = fd.fwd_launch_kinds()
    peak = torch.cuda.max_memory_allocated() / 2**20
    path = os.path.join(eng.output, "mesh", "final_mesh.ply")
    fail_if(not os.path.exists(path), f"mesh: {path} not written")
    verts, tris, colors = read_ply(path)
    n_v, n_t = len(verts), len(tris)
    parts = {k[5:]: eng.timings[k] - before.get(k, 0.0)
             for k in eng.timings if k.startswith("mesh_")}
    want = {f"fine n={chunk}": -(-res_m ** 3 // chunk)}
    for lo in range(0, n_v, chunk):
        key = f"color n={min(chunk, n_v - lo)}"
        want[key] = want.get(key, 0) + 1
    res = {"path": "mesh", "wall_s": wall, "parts_s": parts,
           "peak_mib": peak, "vertices": n_v, "triangles": n_t,
           "k1": counts["fused_decode_fwd"], "k2": counts["fused_decode_bwd"],
           "k1_by_kind": kinds, "k1_schedule": want}
    log("mesh: " + ", ".join(f"{k} {v}" for k, v in res.items()))
    fail_if(n_v == 0 or n_t == 0, f"mesh: V={n_v}, T={n_t}")
    fail_if(kinds != want, f"mesh: K1 launches {kinds}, schedule {want}")
    fail_if(res["k2"] != 0, f"mesh: K2 launched {res['k2']} times")
    mc = np.asarray(eng.cfg["mapping"]["marching_cubes_bound"])
    fail_if(not bool((verts >= mc[:, 0] - 0.05 - 1e-4).all()
                     and (verts <= mc[:, 1] + 0.05 + 1e-4).all()),
            "mesh: vertices outside the padded mesh bound")
    fail_if(colors is None or colors.shape != (n_v, 3)
            or int(tris.min()) < 0 or int(tris.max()) >= n_v,
            "mesh: colours or triangle indices out of range")
    return res


def time_scatter(torch, log, grid_shape, n):
    """The grid backward's scatter of 8 n corner rows into a grid of
    grid_shape (C = 32 channels), at uniform random points: the fixed-order
    scatter_rows against torch.zeros + index_add_ (atomics), which it
    replaced; both allocate their output."""
    from nice_slam_torch.ops.grid import _cell, _corner_rows, scatter_rows

    dev = torch.device("cuda", 0)
    g = torch.Generator(device="cpu").manual_seed(5)
    p_nor = (torch.rand(n, 3, generator=g) * 2 - 1).to(dev)
    shape = tuple(grid_shape) + (HID,)
    i0, i1, _, _ = _cell(shape, p_nor)
    rows = _corner_rows(shape, i0, i1).reshape(-1)
    vals = torch.randn(8 * n, HID, generator=g).to(dev)
    n_rows = shape[0] * shape[1] * shape[2]
    with torch.no_grad():
        a = scatter_rows(rows, vals, n_rows)
        b = torch.zeros(n_rows, HID, device=dev).index_add_(0, rows, vals)
        err = float((a - b).abs().max())
        res = {"grid": list(grid_shape), "points": n,
               "scatter_rows_ms": cuda_time_ms(
                   torch, lambda: scatter_rows(rows, vals, n_rows)),
               "index_add_ms": cuda_time_ms(
                   torch, lambda: torch.zeros(n_rows, HID, device=dev)
                   .index_add_(0, rows, vals)),
               "max_abs_diff": err}
    log("scatter: " + ", ".join(f"{k} {v}" for k, v in res.items()))
    fail_if(not err <= 1e-4, f"scatter: differs from index_add_ by {err}")
    return res


def run_digest(eng) -> tuple:
    """(sha256 of the trajectory, decoders, grids and keyframe store,
    every tracked frame's [first, last, best] loss)."""
    return pipe_digest(eng), [[r[k] for k in ("first_loss", "last_loss",
                                              "best_loss")]
                              for r in eng.stats()]


def run_repeat(torch, fd, log, n_frames=6):
    """Phase 11: the strict path three times from the same seed, graphed,
    eager, graphed: bit-equal states and losses."""
    from nice_slam_torch.config import load_config
    from nice_slam_torch.engine import SlamEngine

    runs = []
    for k, graphed in enumerate((True, False, True)):
        cfg = load_config(SYN_CFG, overrides={
            "synthetic": {"n_frames": n_frames},
            "data": {"output": os.path.join(REPO, "output",
                                            f"chip_smoke_repeat{k}")}})
        eng = SlamEngine(cfg, device="cuda")
        if not graphed:
            eager_engine(eng)
        name = f"repeat{k} ({'graphed' if graphed else 'eager'})"
        res = _drive(torch, fd, eng, log, name, n_frames)
        _check_lagged(cfg, res, n_frames, 0, 0, 0.25)
        fail_if((res["graphs"]["replays"] > 0) != graphed,
                f"{name}: {res['graphs']['replays']} graph replays")
        shapes = {n: tuple(g.shape[:3]) for n, g in
                  eng.map_state.grids.items()}
        runs.append((res, run_digest(eng)))
        del eng
    walls = [r["wall_s"] for r, _ in runs]
    same = [d == runs[0][1] for _, d in runs]
    log(f"repeat: walls graphed {walls[0]:.3f} s, eager {walls[1]:.3f} s, "
        f"graphed {walls[2]:.3f} s (eager / graphed "
        f"{walls[1] / walls[0]:.4f}, {walls[1] / walls[2]:.4f}); ATE "
        f"{[r['ate_rmse_m'] for r, _ in runs]!r}; {len(shapes)} grids; "
        f"equal to the first run: {same}")
    fail_if(len(shapes) != 4, f"repeat: {len(shapes)} grids, want 4")
    fail_if(not all(same), "repeat: the graphed and eager runs differ in "
            "trajectory, decoders, grids, keyframes or tracking losses")
    scatter = [time_scatter(torch, log, shapes[name], 48000)
               for name in ("middle", "fine")]
    r0 = runs[0][0]
    return {"path": "repeat", "ate_rmse_m": [r["ate_rmse_m"] for r, _ in runs],
            "wall_s": walls, "graphed": [True, False, True],
            "k1": r0["k1"], "k2": r0["k2"], "scatter": scatter,
            "graphs": [r["graphs"] for r, _ in runs]}


def run_reduced(torch, fd, log, n_frames=13):
    """Phase 23: every captured signature at reduced depth, graphed then
    eager, bit-equal."""
    from nice_slam_torch.config import load_config
    from nice_slam_torch.engine import SlamEngine

    runs = []
    for graphed in (True, False):
        cfg = load_config(SYN_CFG, overrides={
            "synthetic": {"n_frames": n_frames},
            "mapping": {"every_frame": 2, "keyframe_every": 2,
                        "iters": 15, "iters_first": 30},
            "tracking": {"iters": 5},
            "data": {"output": os.path.join(
                REPO, "output",
                f"chip_smoke_reduced_{'graphed' if graphed else 'eager'}")}})
        eng = SlamEngine(cfg, device="cuda")
        if not graphed:
            eager_engine(eng)
        ba = []
        orig = eng._map

        def _map(idx, color, depth, mapspec, *a, _orig=orig, **k):
            if not mapspec.coarse_mapper and a[2]:
                ba.append(idx)
            return _orig(idx, color, depth, mapspec, *a, **k)

        eng._map = _map
        name = f"reduced ({'graphed' if graphed else 'eager'})"
        res = _drive(torch, fd, eng, log, name, n_frames)
        _check_lagged(cfg, res, n_frames, 0, 0, 0.25)
        events = map_events(n_frames, 2, 0)
        want_ba = ba_events(cfg, n_frames, events)
        fail_if(sorted(set(ba)) != want_ba,
                f"{name}: BA at {sorted(set(ba))}, schedule {want_ba}")
        sig = signatures(eng)
        runs.append((res, run_digest(eng), sig))
        del eng
    (g, d_g, sig), (e, d_e, _) = runs
    log(f"reduced: signatures captured {sig} ({g['graphs']['graphs']} "
        f"graphs, {g['graphs']['capture_s']:.3f} s capturing, pools "
        f"{g['graphs']['pool_mib']:.1f} MiB, peak {g['peak_mib']:.1f} "
        f"MiB); walls graphed {g['wall_s']:.3f} s, eager {e['wall_s']:.3f} "
        f"s; BA at {want_ba}; bit-equal: {d_g == d_e}")
    fail_if(e["graphs"]["replays"] != 0 or g["graphs"]["replays"] == 0,
            "reduced: graph replays in the wrong run")
    fail_if(set(sig["map"]) != {"middle", "fine", "color", "coarse"}
            or not sig["track"], f"reduced: signatures {sig}")
    fail_if(d_g != d_e, "reduced: the graphed and eager runs differ in "
            "trajectory, decoders, grids, keyframes or tracking losses")
    return {**g, "path": "reduced", "eager_wall_s": e["wall_s"],
            "signatures": sig, "ba_events": want_ba}


# ---------------------------------------------------------------------------
# Phases 12-14: Gauss-Newton with BA, occupancy-guided, pretraining

def ba_events(cfg, n_img: int, events):
    """The mapping events at which local BA runs: more than four keyframes
    before the event; keyframes are inserted at events on the
    keyframe_every cadence and at the last two frames."""
    m = cfg["mapping"]
    kf, out = 0, []
    for idx in events:
        if kf > 4 and m["BA"]:
            out.append(idx)
        if idx % m["keyframe_every"] == 0 or idx >= n_img - 2:
            kf += 1
    return out


def gn_launches(cfg, n_img: int, tracked, ba_at):
    """The Gauss-Newton share of the fused-decode launches: per GN
    iteration one forward and one backward for the Jacobian and one
    forward for the candidate's SSE, at Wn x pixels x samples points
    (tracking: a one-frame window of tracking.pose_GN_pixels; mapping:
    the BA window of mapping.pose_GN_pixels per frame, doubled with five
    passes at the colour refinement).  Returns (K1, K2, K1 by kind)."""
    m, t, r = cfg["mapping"], cfg["tracking"], cfg["rendering"]
    per_ray = r["N_samples"] + r["N_surface"]
    runs = [(1, t["pose_GN_pixels"], t["pose_GN_iters"])
            for _ in tracked]
    for idx in ba_at:
        refine = idx == n_img - 1 and m["color_refine"]
        wn = m["mapping_window_size"] * (2 if refine else 1)
        runs += [(wn, m.get("pose_GN_pixels", 200),
                  m["pose_GN_iters"])] * (5 if refine else 1)
    k1 = k2 = 0
    kinds = {}
    for wn, pix, iters in runs:
        key = f"color n={wn * pix * per_ray}"
        kinds[key] = kinds.get(key, 0) + 2 * iters
        k1, k2 = k1 + 2 * iters, k2 + iters
    return k1, k2, kinds


def _merge_kinds(a: dict, b: dict) -> dict:
    out = dict(a)
    for k, v in b.items():
        out[k] = out.get(k, 0) + v
    return out


def check_gn_system(torch, fd, args, log):
    """H and b of one GN system through the kernels against the plain
    route (reverse mode through reference_nice_decode) on the same rays.
    Tolerance: relative Frobenius error <= 1e-3 over H and over b, from
    the rays whose Jacobian rows agree (rtol 1e-3, atol 1e-4 of the
    largest entry); at most max(2, rays / 1000) rays may differ, by a
    ReLU that flips between the two summation orders (fault 5).  The
    check's own launches are taken out of the counts."""
    from nice_slam_torch.models import decoders
    from nice_slam_torch.parallel import schur_ba

    (params, grids, bound, window, cams, _lr, camera, rspec, mspec, pix_n,
     _damping) = args[:11]
    saved = (fd.FusedNiceDecode.fwd_launches, fd.FusedNiceDecode.bwd_launches,
             dict(fd.FusedNiceDecode.fwd_kinds),
             dict(fd.FusedNiceDecode.bwd_kinds))
    gen = torch.Generator(device=cams.device).manual_seed(12)
    pix = schur_ba.window_pixels(gen, cams.shape[0], pix_n, camera,
                                 cams.device)
    jac = {}
    for route in ("kernel", "plain"):
        orig = decoders.fused_nice_decode
        if route == "plain":
            decoders.fused_nice_decode = (
                lambda wc, _tw, p, cm, cf, cc, *ws:
                fd.reference_nice_decode(wc, p, cm, cf, cc, *ws))
        try:
            jac[route] = schur_ba.pose_jacobian(params, grids, bound, window,
                                                cams, camera, rspec, mspec,
                                                pix)
        finally:
            decoders.fused_nice_decode = orig
    torch.cuda.synchronize()
    (fd.FusedNiceDecode.fwd_launches, fd.FusedNiceDecode.bwd_launches,
     fd.FusedNiceDecode.fwd_kinds, fd.FusedNiceDecode.bwd_kinds) = saved
    (Jk, rk), (Jp, rp) = jac["kernel"], jac["plain"]
    scale = float(Jp.abs().max())
    agree = torch.isclose(Jk, Jp, rtol=1e-3, atol=1e-4 * scale).all(-1) \
        & torch.isclose(rk, rp, rtol=1e-3, atol=1e-4 * float(
            rp.abs().max())) & torch.isfinite(Jk).all(-1)
    n_rays = agree.numel()
    flips = int((~agree).sum())
    a = agree.to(Jk.dtype)[..., None]

    def system(J, r):
        J = J * a
        return (J.transpose(1, 2) @ J, (J.transpose(1, 2) @ (r[..., None] * a))[..., 0])

    (Hk, bk), (Hp, bp) = system(Jk, rk), system(Jp, rp)
    eh = float((Hk - Hp).norm() / Hp.norm())
    eb = float((bk - bp).norm() / bp.norm())
    log(f"gn: H/b check at frame 1 ({n_rays} rays): kernel vs plain "
        f"relative error H {eh:.3g}, b {eb:.3g}; {flips} rays differ "
        f"(ReLU flips allowed: {max(2, n_rays // 1000)})")
    fail_if(flips > max(2, n_rays // 1000),
            f"gn: {flips} of {n_rays} Jacobian rows differ")
    fail_if(not (eh <= 1e-3 and eb <= 1e-3),
            f"gn: H/b relative error {eh}, {eb} > 1e-3")
    return max(eh, eb)


def gn_schedule(cfg, n_frames: int) -> dict:
    """The launches of a strict GN + BA run: the base schedule plus GN's
    (`gn_launches`) at the BA events."""
    m = cfg["mapping"]
    events = map_events(n_frames, m["every_frame"], 0)
    want_ba = ba_events(cfg, n_frames, events)
    base_f, base_b, base_k = expected_launches(cfg, n_frames, events=events)
    gn_f, gn_b, gn_k = gn_launches(cfg, n_frames, range(1, n_frames),
                                   want_ba)
    return {"k1": base_f + gn_f, "k2": base_b + gn_b, "gn_k1": gn_f,
            "gn_k2": gn_b, "k1_by_kind": _merge_kinds(base_k, gn_k),
            "ba_events": want_ba}


def occ_schedule(cfg, n_frames: int, nodes: int) -> dict:
    """The launches of a strict occupancy-guided run: the base schedule
    plus one K1 at the proxy's nodes (fine) per refresh, one a NICE
    mapping pass (the colour refinement has five)."""
    m = cfg["mapping"]
    events = map_events(n_frames, m["every_frame"], 0)
    passes = sum(5 if i == n_frames - 1 and m["color_refine"] else 1
                 for i in events)
    base_f, base_b, base_k = expected_launches(cfg, n_frames, events=events)
    return {"k1": base_f + passes, "k2": base_b, "refreshes": passes,
            "k1_by_kind": _merge_kinds(base_k, {f"fine n={nodes}": passes})}


def run_gn(torch, fd, log):
    """Phase 12: strict, GN in tracking and mapping, BA on from event 10.
    Each GN iteration is a replayed graph: its time is read around the
    runner's step (synchronised), its accept flags from the runner's
    buffer."""
    from nice_slam_torch.engine import SlamEngine
    from nice_slam_torch.parallel import schur_ba

    cfg, n_frames = path_cfg("gn")
    eng = SlamEngine(cfg, device="cuda")
    ba_calls, gn, cur = [], [], {}
    check = {}
    orig_map, orig_iter = eng._map, schur_ba.gn_iteration
    orig_refine = schur_ba.schur_pose_refine

    def _map(idx, color, depth, mapspec, *a, **k):
        if not mapspec.coarse_mapper:
            ba_calls.append((idx, bool(a[2])))
        return orig_map(idx, color, depth, mapspec, *a, **k)

    def gn_iteration(*a, **k):
        # the first call is the first tracked frame's eager warm-up
        if not check:
            t0 = time.perf_counter()
            check["err"] = check_gn_system(torch, fd, a, log)
            check["s"] = time.perf_counter() - t0
        return orig_iter(*a, **k)

    def schur_pose_refine(*a, **k):
        cams, mask = a[4], a[5]
        cur.update(wn=int(cams.shape[0]), live=int((mask > 0).sum()),
                   acc=("gn_accept", cams.shape[0], cams.device))
        return orig_refine(*a, **k)

    def timed(runner):
        orig_step = runner.step

        def step(key, fn, generators=()):
            if key[0] != "gn":
                return orig_step(key, fn, generators)
            torch.cuda.synchronize()
            s0 = check.get("s", 0.0)
            t0 = time.perf_counter()
            orig_step(key, fn, generators)
            torch.cuda.synchronize()
            gn.append({"wn": cur["wn"], "live": cur["live"],
                       "s": time.perf_counter() - t0
                       - (check.get("s", 0.0) - s0),
                       "accepted": int(runner._buffers[cur["acc"]].sum())})

        runner.step = step

    eng._map = _map
    timed(eng._track_graphs)
    timed(eng._map_graphs)
    schur_ba.gn_iteration = gn_iteration
    schur_ba.schur_pose_refine = schur_pose_refine
    try:
        res = _drive(torch, fd, eng, log, "gn", n_frames)
    finally:
        schur_ba.gn_iteration = orig_iter
        schur_ba.schur_pose_refine = orig_refine
    res["signatures"] = check_graphed(log, "gn", eng, res, PATH_SIGS["gn"])
    kinds_f, kinds_b = fd.fwd_launch_kinds(), fd.bwd_launch_kinds()
    res.update({"k1_by_kind": kinds_f, "k2_by_kind": kinds_b})
    # the H/b check ran inside the first tracked frame: not the path's time
    res["wall_s"] -= check["s"]
    res["frames_per_s"] = res["frames"] / res["wall_s"]
    m = cfg["mapping"]
    want = gn_schedule(cfg, n_frames)
    got_ba = sorted({i for i, b in ba_calls if b})
    gn_track = sum(g["s"] for g in gn if g["wn"] == 1)
    gn_map = sum(g["s"] for g in gn if g["wn"] > 1)
    timings = res["timings"]
    res.update({
        "ba_events": got_ba, "ba_passes": sum(b for _, b in ba_calls),
        "gn_iterations": {"track": sum(g["wn"] == 1 for g in gn),
                          "map": sum(g["wn"] > 1 for g in gn)},
        "gn_accepted_share": (sum(g["accepted"] for g in gn)
                              / max(sum(g["live"] for g in gn), 1)),
        "gn_share_of_track": gn_track / (timings["track"] - check["s"]),
        "gn_share_of_map": gn_map / timings["map"],
        "hb_rel_err": check["err"],
        "schedule": {k: want[k] for k in ("k1", "k2", "gn_k1", "gn_k2")}})
    log(f"gn: BA at events {got_ba} (schedule {want['ba_events']}), "
        f"{res['ba_passes']} BA passes; GN iterations "
        f"{res['gn_iterations']}, accepted share "
        f"{res['gn_accepted_share']:.4f}, share of track time "
        f"{res['gn_share_of_track']:.4f}, of map time "
        f"{res['gn_share_of_map']:.4f}; launches K1 {res['k1']} = "
        f"{want['k1'] - want['gn_k1']} + GN {want['gn_k1']}, K2 "
        f"{res['k2']} = {want['k2'] - want['gn_k2']} + GN {want['gn_k2']} "
        f"(GN: per iteration K1 x2, K2 x1); K1 by kind {kinds_f} (schedule "
        f"{want['k1_by_kind']}); K2 by kind {kinds_b}; wall without the "
        f"check {res['wall_s']:.3f} s")
    fail_if(got_ba != want["ba_events"],
            f"gn: BA at {got_ba}, schedule {want['ba_events']}")
    fail_if((res["k1"], res["k2"], kinds_f)
            != (want["k1"], want["k2"], want["k1_by_kind"]),
            "gn: launches differ from the schedule")
    r = cfg["rendering"]
    refine_n = (2 * m["mapping_window_size"] * m.get("pose_GN_pixels", 200)
                * (r["N_samples"] + r["N_surface"]))
    fail_if(kinds_b.get(f"color no-wgrad n={refine_n}", 0)
            != 5 * m["pose_GN_iters"],
            "gn: K2 launches at the colour refinement's GN shape")
    ate = res["ate_rmse_m"]
    fail_if(not math.isfinite(ate) or ate > 0.25,
            f"gn: ATE {ate} not finite or above 0.25 m")
    return res


def run_occ(torch, fd, log, strict_ate):
    """Phase 13: strict, occupancy-guided sampling."""
    from nice_slam_torch import mapping
    from nice_slam_torch.engine import SlamEngine

    cfg, n_frames = path_cfg("occ")
    eng = SlamEngine(cfg, device="cuda")
    shape = tuple(eng.map_state.grids["occ_proxy"].shape[:3])
    nodes = shape[0] * shape[1] * shape[2]
    refreshed = []
    orig = mapping.refresh_occ_proxy

    def refresh(*a, **k):
        out = orig(*a, **k)
        refreshed.append(float(out.min()))
        return out

    mapping.refresh_occ_proxy = refresh
    try:
        res = _drive(torch, fd, eng, log, "occ", n_frames)
    finally:
        mapping.refresh_occ_proxy = orig
    res["signatures"] = check_graphed(log, "occ", eng, res,
                                      PATH_SIGS["occ"])
    kinds = fd.fwd_launch_kinds()
    res.update({"k1_by_kind": kinds, "k2_by_kind": fd.bwd_launch_kinds()})
    want = occ_schedule(cfg, n_frames, nodes)
    passes = want["refreshes"]
    res.update({"proxy_shape": list(shape), "refreshes": len(refreshed),
                "proxy_min_after_each": refreshed,
                "strict_ate_rmse_m": strict_ate})
    log(f"occ: proxy {shape} ({nodes} nodes), {len(refreshed)} refreshes "
        f"(schedule {passes}), min after each {refreshed}; K1 by kind "
        f"{kinds} (schedule {want['k1_by_kind']}); ATE {res['ate_rmse_m']} "
        f"m against strict {strict_ate} m")
    fail_if(len(refreshed) != passes or not refreshed[0] < 0.5,
            "occ: the proxy was not refreshed as scheduled")
    fail_if((res["k1"], res["k2"], kinds)
            != (want["k1"], want["k2"], want["k1_by_kind"]),
            "occ: launches differ from the schedule")
    ate = res["ate_rmse_m"]
    fail_if(not math.isfinite(ate) or ate > 0.3,
            f"occ: ATE {ate} not finite or above 0.3 m")
    p = os.path.join(eng.output, "occ_resume.npz")
    eng.save(p)
    back = SlamEngine(cfg, device="cuda").resume(p)
    differ = [k for k, v in eng.map_state.grids.items()
              if not torch.equal(v, back.map_state.grids[k])]
    fail_if(set(back.map_state.grids) != set(eng.map_state.grids)
            or bool(differ), f"occ: grids after save/load differ: {differ}")
    log(f"occ: save/load: {len(eng.map_state.grids)} grids bit-equal, "
        "occ_proxy among them")
    return res


def run_reduced_modes(torch, fd, log):
    """Phase 24: iMAP*, occupancy-guided and GN + BA at full width and
    reduced depth (REDUCED), eager (each signature's second iteration,
    the one a graphed run captures, under sync-debug "error": the sweep
    for host reads), then graphed: bit-equal, launches the schedule's in
    both, and the sweep must have covered every signature the graphed
    run captured."""
    from nice_slam_torch.engine import SlamEngine

    out = {}
    for name in ("imap", "occ", "gn"):
        runs = []
        for graphed in (False, True):
            tag = "graphed" if graphed else "eager"
            cfg, n_frames = path_cfg(name, reduced=True, tag=tag)
            eng = SlamEngine(cfg, device="cuda")
            if not graphed:
                eng._track_graphs = sync_check_runner(eng._track_graphs)
                eng._map_graphs = sync_check_runner(eng._map_graphs)
            label = f"{name} reduced ({tag})"
            res = _drive(torch, fd, eng, log, label, n_frames)
            if name == "imap":
                want = {"k1": 0, "k2": 0}
            elif name == "gn":
                want = gn_schedule(cfg, n_frames)
            else:
                g = eng.map_state.grids["occ_proxy"]
                want = occ_schedule(cfg, n_frames, math.prod(g.shape[:3]))
            kinds = fd.fwd_launch_kinds()
            fail_if((res["k1"], res["k2"]) != (want["k1"], want["k2"])
                    or kinds != want.get("k1_by_kind", {}),
                    f"{label}: launches K1 {res['k1']} {kinds} K2 "
                    f"{res['k2']}, schedule {want}")
            ate = res["ate_rmse_m"]
            fail_if(not math.isfinite(ate), f"{label}: ATE {ate}")
            if graphed:
                res["signatures"] = check_graphed(log, label, eng, res,
                                                  PATH_SIGS[name])
            else:
                res["sync_checked"] = sorted(
                    {k[2] if k[0] == "map" else k[0]
                     for r in (eng._track_graphs, eng._map_graphs)
                     for k in r.checked})
                fail_if(res["graphs"]["replays"] != 0,
                        f"{label}: graph replays in the eager run")
            runs.append((res, run_digest(eng)))
            del eng
        (e, d_e), (g, d_g) = runs
        log(f"{name} reduced: walls graphed {g['wall_s']:.3f} s, eager "
            f"{e['wall_s']:.3f} s (eager / graphed "
            f"{e['wall_s'] / g['wall_s']:.4f}); signatures "
            f"{g['signatures']}; sync-debug \"error\" over the second "
            f"eager iteration of {e['sync_checked']}: no host read; "
            f"bit-equal: {d_g == d_e}")
        fail_if(set(e["sync_checked"]) != {n for side in g["signatures"]
                                          .values() for n in side},
                f"{name} reduced: sync-debug checked {e['sync_checked']}, "
                f"graphed {g['signatures']}")
        fail_if(d_g != d_e, f"{name} reduced: the graphed and eager runs "
                "differ in trajectory, decoders, grids, keyframes or "
                "tracking losses")
        out[name] = {**g, "path": f"{name}_reduced",
                     "eager_wall_s": e["wall_s"],
                     "sync_checked": e["sync_checked"]}
    return out


def _reference_state(dec: dict, prefix: str) -> dict:
    """A decoder of the port as the reference's state_dict entries
    (nn.Linear weights (out, in))."""
    sd = {}
    for i, layer in enumerate(dec["pts"]):
        sd[f"{prefix}pts_linears.{i}.weight"] = layer["w"].T.contiguous()
        sd[f"{prefix}pts_linears.{i}.bias"] = layer["b"]
    for i, layer in enumerate(dec.get("fc_c", [])):
        sd[f"{prefix}fc_c.{i}.weight"] = layer["w"].T.contiguous()
        sd[f"{prefix}fc_c.{i}.bias"] = layer["b"]
    sd[f"{prefix}output_linear.weight"] = dec["out"]["w"].T.contiguous()
    sd[f"{prefix}output_linear.bias"] = dec["out"]["b"]
    if "B" in dec.get("embed", {}):
        sd[f"{prefix}embedder._B"] = dec["embed"]["B"]
    return {k: v.cpu() for k, v in sd.items()}


def run_pretrain(torch, fd, log, dev, steps=100, batch=4096):
    """Phase 14: pretraining on the card, the ported tool, and the npz and
    .pt decoder sources of a fresh engine."""
    import numpy as np

    from nice_slam_torch.config import load_config
    from nice_slam_torch.engine import SlamEngine
    from nice_slam_torch.models.decoders import ModelSpec, init_model
    from nice_slam_torch.models.pretrain import pretrain_decoders_synthetic
    from nice_slam_torch.ops.tree import tree_leaves
    from nice_slam_torch.tools import pretrain_decoders as tool
    from nice_slam_torch.utils.checkpoint import _flatten

    out_dir = os.path.join(REPO, "output", "chip_smoke_pretrain")
    os.makedirs(out_dir, exist_ok=True)
    gen = torch.Generator(device=dev).manual_seed(14)
    params = init_model(gen, ModelSpec(), device=dev)
    before = {k: [x.clone() for x in tree_leaves(v)]
              for k, v in params.items()}
    _release(torch)
    torch.cuda.reset_peak_memory_stats()
    fd.reset_launch_counts()
    t0 = time.perf_counter()
    out, losses = pretrain_decoders_synthetic(
        gen, params, ModelSpec(), tool.BOUND, steps=steps, batch=batch)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    counts = fd.launch_counts()
    kinds_f, kinds_b = fd.fwd_launch_kinds(), fd.bwd_launch_kinds()
    changed = {k: any(not torch.equal(a, b) for a, b in
                      zip(before[k], tree_leaves(out[k]))) for k in before}
    losses = losses.tolist()
    res = {"path": "pretrain", "wall_s": wall, "steps": steps,
           "batch": batch, "ms_per_step": 1e3 * wall / steps,
           "peak_mib": torch.cuda.max_memory_allocated() / 2**20,
           "k1": counts["fused_decode_fwd"], "k2": counts["fused_decode_bwd"],
           "first_loss": losses[0], "last_loss": losses[-1],
           "decoders_changed": changed, "k1_by_kind": kinds_f,
           "k2_by_kind": kinds_b}
    log("pretrain: " + ", ".join(f"{k} {v}" for k, v in res.items())
        + f"; K1 by kind {kinds_f}; K2 by kind {kinds_b}")
    fail_if(kinds_f != {f"fine n={batch}": steps}
            or kinds_b != {f"fine wgrad n={batch}": steps},
            "pretrain: launches differ from one K1 and one K2 per step")
    fail_if(changed != {"coarse": False, "middle": True, "fine": True,
                        "color": False},
            f"pretrain: decoders trained {changed}, want middle and fine")
    fail_if(not losses[-1] < losses[0], "pretrain: the loss did not fall")

    # the ported tool, into a file of its own
    npz = os.path.join(out_dir, "decoders.npz")
    t0 = time.perf_counter()
    tool.main(["--scenes", "3", "--steps", "80", "--batch", "8192",
               "--out", npz, "--report_every", "1", "--device", str(dev)])
    res["tool_wall_s"] = time.perf_counter() - t0
    res["tool_ms_per_step"] = 1e3 * res["tool_wall_s"] / (3 * 80)
    with np.load(npz) as z:
        saved = {k: z[k] for k in z.files}
    cfg = load_config(SYN_CFG, overrides={
        "synthetic": {"n_frames": 2},
        "pretrained_decoders": {"tpu_npz": npz},
        "data": {"output": os.path.join(out_dir, "engine")}})
    eng = SlamEngine(cfg, device="cuda")
    now = {}
    _flatten(eng.map_state.params, "params", now)
    differ = [k for k in saved if not np.array_equal(now[k], saved[k])]
    fail_if(set(now) != set(saved) or bool(differ),
            f"pretrain: the engine's decoders differ from the npz: {differ}")
    # a reference-format .pt pair of those decoders, read by a fresh engine
    src = eng.map_state.params
    pts = (os.path.join(out_dir, "coarse.pt"),
           os.path.join(out_dir, "middle_fine.pt"))
    torch.save({"model": _reference_state(src["coarse"], "decoder.")},
               pts[0])
    torch.save({"model": {**_reference_state(src["middle"],
                                             "decoder.coarse."),
                          **_reference_state(src["fine"], "decoder.fine.")}},
               pts[1])
    cfg["pretrained_decoders"] = {"tpu_npz": os.path.join(out_dir, "none"),
                                  "coarse": pts[0], "middle_fine": pts[1]}
    eng_pt = SlamEngine(cfg, device="cuda")
    got = {}
    _flatten(eng_pt.map_state.params, "params", got)
    differ = [k for k in now if not k.startswith("params/color/")
              and not np.array_equal(got[k], now[k])]
    fail_if(set(got) != set(now) or bool(differ)
            or not all(x.device.type == dev.type
                       for x in tree_leaves(eng_pt.map_state.params)),
            f"pretrain: .pt decoders differ from their source: {differ}")
    log(f"pretrain: tool {3 * 80} steps in {res['tool_wall_s']:.3f} s "
        f"({res['tool_ms_per_step']:.3f} ms/step); the engine read its "
        f"npz ({len(saved)} arrays) and the .pt pair made from it, equal")
    return res


# ---------------------------------------------------------------------------
# Phases 15-17: data-parallel, pipelined, reconstruction evaluation

DP_WORLD = 2
DP_STAGES = (("middle", 1), ("fine", 1), ("color", 1))
# the graphed-against-eager calls of phases 15 and 18: every segment
# signature warmed up, captured and replayed eight times
DP_LONG = (("middle", 10), ("fine", 10), ("color", 10))
# their segment signatures: (step, stage, segments)
DP_LONG_SIGS = (("map", "middle", 2), ("map", "fine", 2),
                ("map", "color", 2), ("gn", None, 3))


def _rank_summaries(stdout: str) -> list:
    """The JSON summaries that run_torch.py's ranks printed, by rank."""
    dec = json.JSONDecoder()
    out, k = [], stdout.find("{\n")
    while k >= 0:
        obj, end = dec.raw_decode(stdout, k)
        out.append(obj)
        k = stdout.find("{\n", end)
    return sorted(out, key=lambda s: s["rank"])


def _rel_err(torch, a, b) -> float:
    """Relative Frobenius error of a against b (0 when both are 0)."""
    nb = float(torch.linalg.vector_norm(b.double()))
    na = float(torch.linalg.vector_norm((a - b).double()))
    return na / nb if nb > 0 else (0.0 if na == 0 else math.inf)


def dp_setup(torch, dev):
    """A full-width mapping window of the synthetic scene for the union
    check: keyframes 0, 2, 4, 6 and the current frame 8 at their GT poses
    (the BA cameras then moved by 1 cm), the repository's decoders and
    random grids from the config's seed, BA and one Gauss-Newton
    iteration at 200 rays a window frame and rank; and the union's pixels
    of the three iterations (middle, fine, colour), 2 x 1,000 rays each.
    The same in every process.

    One GN iteration: a second starts from cameras that differ by the
    first solve's rounding, and its ray masks (valid depth, in bound) are
    discontinuous in the pose, so its sums differ by whole rays, far above
    1e-5 at this width; tests/test_torch_parallel.py holds two iterations
    at a small width."""
    import dataclasses

    from nice_slam_torch import mapping
    from nice_slam_torch.config import load_config
    from nice_slam_torch.engine import SlamEngine
    from nice_slam_torch.keyframes import add_keyframe
    from nice_slam_torch.parallel.schur_ba import window_pixels

    cfg = load_config(SYN_CFG, overrides={"synthetic": {"n_frames": 9}})
    eng = SlamEngine(cfg, device=str(dev))
    frames = {k: eng._load_frame(k) for k in (0, 2, 4, 6, 8)}
    for k in (0, 2, 4, 6):
        c, d, p = frames[k]
        pose = torch.as_tensor(p, device=dev)
        add_keyframe(eng.store, c, d, pose, pose, k)
    c, d, p = frames[8]
    spec = dataclasses.replace(eng.specs.mapper, pose_gn_iters=1,
                               pose_gn_pixels=200)
    window, masks, cams0, lr_mask = mapping.prepare_mapping(
        eng.store, c, d, torch.as_tensor(p, device=dev), eng.map_state.grids,
        eng.bound, eng.specs.camera, spec, True,
        gen=torch.Generator(device=dev).manual_seed(1),
        mask_names=mapping._trained_grids(spec, DP_STAGES))
    g = torch.Generator().manual_seed(4)
    cams0 = cams0 + 0.01 * torch.randn(cams0.shape, generator=g).to(dev)
    wn = window["colors"].shape[0]
    pixels = [tuple(x.to(dev) for x in window_pixels(
        g, wn, DP_WORLD * (spec.pixels // wn), eng.specs.camera, "cpu"))
        for _ in DP_STAGES]
    st = eng.map_state
    return (eng.specs, st.params, st.grids, st.bound, window, masks, cams0,
            lr_mask, spec, pixels)


def dp_union_call(torch, dev, world_one: bool, graphs=None,
                  long: bool = False):
    """One data-parallel mapping call of the union check, its reduces
    recorded: (the summed [loss, live gradients] of each stage iteration
    and the Gauss-Newton sums [H, b, sse0], [sse1, cnt0, cnt1] of each GN
    iteration, the final params + grids leaves, the cameras, the losses,
    the call's seconds (synchronised), the reduces' seconds).  world_one:
    this process alone, on the union (twice the rank's pixels).  `graphs`:
    the mapping runner (None: eager).  `long`: DP_LONG's stages on drawn
    pixels with two Gauss-Newton iterations, so that every segment
    signature is captured and replayed (the graphed-against-eager check)."""
    import dataclasses

    from nice_slam_torch import mapping
    from nice_slam_torch.ops.tree import tree_leaves
    from nice_slam_torch.parallel.data_parallel import RayShard

    class Recording(RayShard):
        def reduce_(self, bucket, kind="gn"):
            super().reduce_(bucket, kind)
            self.sums.append([t.detach().clone() for t in bucket.views()])

    (specs, params, grids, bound, window, masks, cams0, lr_mask, spec,
     pixels) = dp_setup(torch, dev)
    shard = Recording()
    shard.sums = []
    stages = DP_STAGES
    if long:
        stages, pixels = DP_LONG, None
        spec = dataclasses.replace(spec, pose_gn_iters=2)
    if world_one:
        spec = dataclasses.replace(spec, pixels=DP_WORLD * spec.pixels,
                                   pose_gn_pixels=DP_WORLD
                                   * spec.pose_gn_pixels)
    _sync(torch, dev)
    t0 = time.perf_counter()
    p, g, cams, losses = mapping.map_optimize(
        params, grids, bound, window, cams0, masks, lr_mask, 1.0,
        specs.camera, stages, spec, specs.render, specs.model, ba=True,
        gen=torch.Generator(device=dev).manual_seed(3), pixels=pixels,
        shard=shard, graphs=graphs)
    _sync(torch, dev)
    secs = time.perf_counter() - t0
    return (shard.sums, tree_leaves(p) + tree_leaves(g), cams, losses, secs,
            shard.seconds)


def _sync(torch, dev):
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)


def _same(torch, a, b) -> bool:
    """Bit-equality of tensors, nested lists of them and other values."""
    if isinstance(a, torch.Tensor):
        return isinstance(b, torch.Tensor) and torch.equal(a, b)
    if isinstance(a, (list, tuple)):
        return (isinstance(b, (list, tuple)) and len(a) == len(b)
                and all(_same(torch, x, y) for x, y in zip(a, b)))
    return a == b


def _same_call(torch, a, b) -> bool:
    """Whether two union-check calls' results (their first four: the
    reduced sums, leaves, cameras, losses) are bit-equal."""
    return _same(torch, list(a[:4]), list(b[:4]))


def graphed_against_eager(torch, dev, call):
    """`call(graphs)` eagerly with each segment's second iteration under
    sync-debug "error" (`sync_check_runner`), then graphed, in this
    process: (eager result, graphed result, the signatures the sweep
    checked, the graphed runner's stats)."""
    from nice_slam_torch.graphs import StepGraphs

    checker = sync_check_runner(StepGraphs(dev, capture=False))
    eager = call(checker)
    runner = StepGraphs(dev)
    graphed = call(runner)
    return eager, graphed, checker.checked, runner.stats()


def _sig_names(keys) -> list:
    """A runner's signatures by name: (step, stage or None, segment)."""
    return sorted({(k[0], k[2] if k[0] in ("map", "gs") else None,
                    k[-1][1]) for k in keys})


def dp_rank_main(rank: int, port: int, out: str, device: str) -> int:
    """One rank of the union check (chip_smoke.py --dp-rank R --port P
    --out FILE --device D): saves its reduced sums and results, and the
    graphed-against-eager checks: the union call eager then graphed, and
    the long call eager (the sync-debug sweep over its segments) then
    graphed; each pair bit-equal; their seconds."""
    import numpy as np
    import torch

    from nice_slam_torch.graphs import StepGraphs
    from nice_slam_torch.parallel import multihost

    torch.backends.cuda.matmul.allow_tf32 = False
    multihost.initialize(f"127.0.0.1:{port}", DP_WORLD, rank, timeout_s=300,
                         device=device)
    dev = multihost.rank_device(device, rank)
    union = dp_union_call(torch, dev, False)
    union_g = dp_union_call(torch, dev, False, graphs=StepGraphs(dev))
    eager, graphed, checked, stats = graphed_against_eager(
        torch, dev, lambda r: dp_union_call(torch, dev, False, graphs=r,
                                            long=True))
    sums, leaves, cams, losses = union[:4]
    arrays = {f"sum{i}_{k}": t.cpu().numpy() for i, s in enumerate(sums)
              for k, t in enumerate(s)}
    arrays.update({f"leaf{k}": t.detach().cpu().numpy()
                   for k, t in enumerate(leaves)})
    arrays["cams"] = cams.detach().cpu().numpy()
    arrays["losses"] = losses.cpu().numpy()
    arrays["backend"] = np.array(multihost.backend())
    arrays["graphed"] = np.array(json.dumps({
        "union_equal": _same_call(torch, union, union_g),
        "long_equal": _same_call(torch, eager, graphed),
        "union_s": [union[4], union_g[4]],
        "long_s": [eager[4], graphed[4]],
        "long_reduce_s": [eager[5], graphed[5]],
        "reduces": [len(eager[0]), len(graphed[0])],
        "sync_checked": _sig_names(checked), "stats": stats}))
    np.savez(out, **arrays)
    multihost.shutdown()
    return 0


def check_dp_union(torch, log, out_dir, device="cuda"):
    """Two ranks of one mapping call over gloo on the card against this
    process on the union: each iteration's summed loss and gradients, the
    GN system and the updated leaves within a relative Frobenius error of
    1e-5, the GN guard's sums within 1e-4.  On every rank, graphed equals
    eager bit for bit (every reduced sum, leaf, the cameras, the losses)
    in the union call and in a longer one (DP_LONG) whose eager run the
    sync-debug sweep checked over every segment signature the graphed run
    captured; prints each rank's seconds, eager and graphed."""
    import numpy as np

    from nice_slam_torch.parallel.multihost import free_port, rank_world

    fail_if(rank_world()[1] != 1, "dp: the smoke itself joined a group")
    port = free_port()
    t0 = time.perf_counter()
    procs = [subprocess.Popen(
        [sys.executable, os.path.abspath(__file__), "--dp-rank", str(r),
         "--port", str(port), "--device", device, "--out",
         os.path.join(out_dir, f"union_rank{r}.npz")],
        cwd=REPO, stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
        text=True) for r in range(DP_WORLD)]
    logs = [p.communicate(timeout=600)[0] for p in procs]
    for r, (p, text) in enumerate(zip(procs, logs)):
        fail_if(p.returncode != 0,
                f"dp union: rank {r} exited {p.returncode}: {text[-3000:]}")
    ranks_s = time.perf_counter() - t0
    dev = torch.device(device)
    sums, leaves, cams, losses = dp_union_call(torch, dev, True)[:4]
    want = {f"sum{i}_{k}": t for i, s in enumerate(sums)
            for k, t in enumerate(s)}
    want.update({f"leaf{k}": t.detach() for k, t in enumerate(leaves)})
    want["cams"], want["losses"] = cams.detach(), losses
    worst, graphed = {}, []
    for r in range(DP_WORLD):
        with np.load(os.path.join(out_dir, f"union_rank{r}.npz")) as z:
            got = {k: z[k] for k in z.files}
        graphed.append(json.loads(str(got.pop("graphed"))))
        fail_if(set(got) - {"backend"} != set(want),
                f"dp union: rank {r} has {sorted(got)}, want {sorted(want)}")
        for k, w in want.items():
            e = _rel_err(torch, torch.as_tensor(got[k]).to(dev), w)
            worst[k] = max(worst.get(k, 0.0), e)
    # the guard's sums [sse1, cnt0, cnt1] are taken at the candidate
    # cameras, which carry the 7x7 solve's rounding: 1e-4
    guard = f"sum{len(DP_STAGES) + 1}_"
    bad = {k: e for k, e in worst.items()
           if not e <= (1e-4 if k.startswith(guard) else 1e-5)}
    n_sums = sum(1 for k in want if k.startswith("sum"))
    log(f"dp union: {DP_WORLD} ranks ({ranks_s:.2f} s) against one process "
        f"on the union: {n_sums} summed tensors and {len(want) - n_sums} "
        f"results, max relative error sums "
        f"{max(e for k, e in worst.items() if k.startswith('sum')):.3g}, "
        f"results {max(e for k, e in worst.items() if not k.startswith('sum')):.3g}")
    fail_if(bool(bad), f"dp union: relative errors above 1e-5: {bad}")
    res = {"max_rel_err": max(worst.values())}
    res.update(check_graphed_ranks(log, "dp", graphed, DP_LONG_SIGS))
    return res


def check_graphed_ranks(log, name, graphed, want_sigs) -> dict:
    """The ranks' graphed-against-eager records (phases 15 and 18): both
    pairs bit-equal, the same reduces in each, every segment signature of
    `want_sigs` ((step, stage, segments) each) captured, and the sweep
    over the eager run checked each of them.  Prints and returns the
    seconds by rank."""
    want = sorted((step, stage, i) for step, stage, n in want_sigs
                  for i in range(n))
    for r, g in enumerate(graphed):
        fail_if(not (g["union_equal"] and g["long_equal"]),
                f"{name} union: rank {r}'s graphed calls differ from its "
                f"eager calls (union {g['union_equal']}, long "
                f"{g['long_equal']})")
        fail_if(g["reduces"][0] != g["reduces"][1],
                f"{name} union: rank {r} reduced {g['reduces']} times "
                "(eager, graphed)")
        fail_if(sorted(map(tuple, g["sync_checked"])) != want
                or g["stats"]["segments"] != len(want),
                f"{name} union: rank {r} swept {g['sync_checked']}, "
                f"captured {g['stats']['segments']} segments, want {want}")
    out = {"union_s_eager_graphed": [g["union_s"] for g in graphed],
           "long_s_eager_graphed": [g["long_s"] for g in graphed],
           "long_collective_s_eager_graphed": [g["long_reduce_s"]
                                               for g in graphed],
           "long_stats": graphed[0]["stats"], "sync_checked": len(want)}
    log(f"{name} union graphed: bit-equal to eager on every rank; sync-debug "
        f"\"error\" over the second eager iteration of {len(want)} segment "
        f"signatures: no host read; " + json.dumps(out))
    return out


def _launch_ranks(torch, log, name, tpu, world, n_frames, device,
                  overrides):
    """run_torch.py's local launch of `world` ranks on the strict config
    with `tpu` (output/chip_smoke_<name>), then the checks every parallel
    run shares: a summary of every rank, the ranks' trajectories, grids
    and decoders bit-equal, each rank's K1/K2 launches equal to the
    single-rank schedule, the ATE finite and under 0.25 m, only rank 0
    wrote ckpts/.  Returns (ranks' summaries, result dict, output dir)."""
    import shutil

    import yaml

    from nice_slam_torch.config import load_config

    out = os.path.join(REPO, "output", f"chip_smoke_{name}")
    shutil.rmtree(out, ignore_errors=True)
    os.makedirs(out)
    cfg_path = os.path.join(out, f"{name}.yaml")
    with open(cfg_path, "w") as f:
        yaml.safe_dump({"inherit_from": SYN_CFG,
                        "synthetic": {"n_frames": n_frames}, "tpu": tpu,
                        "data": {"output": out}, **(overrides or {})}, f)
    cfg = load_config(cfg_path)
    _release(torch)
    t0 = time.perf_counter()
    r = subprocess.run([sys.executable, os.path.join(REPO, "run_torch.py"),
                        cfg_path, "--no-mesh", "--device", device], cwd=REPO,
                       capture_output=True, text=True, timeout=900)
    launch_s = time.perf_counter() - t0
    fail_if(r.returncode != 0,
            f"{name}: run_torch.py exited {r.returncode}: {r.stderr[-3000:]}")
    ranks = _rank_summaries(r.stdout)
    fail_if([s["rank"] for s in ranks] != list(range(world)),
            f"{name}: summaries of ranks {[s['rank'] for s in ranks]}")
    exp_f, exp_b, _ = expected_launches(cfg, n_frames)
    s0 = ranks[0]
    k1 = [s["launches"]["fused_decode_fwd"] for s in ranks]
    k2 = [s["launches"]["fused_decode_bwd"] for s in ranks]
    res = {"path": name, "ranks": world, "backend": s0["backend"],
           "launch_s": launch_s, "wall_s": [s["wall_s"] for s in ranks],
           "frames": n_frames,
           "frames_per_s": [n_frames / s["wall_s"] for s in ranks],
           "ate_rmse_m": s0["ate_rmse_m"],
           "peak_mib": [s["peak_mib"] for s in ranks],
           "k1": k1[0], "k2": k2[0], "k1_by_rank": k1, "k2_by_rank": k2,
           "timings": [s["timings_s"] for s in ranks],
           "written": [s["written"] for s in ranks],
           "graphs": [s["graphs"] for s in ranks]}
    fail_if(any(s["world"] != world for s in ranks), f"{name}: world size")
    fail_if(any((s["traj_sha256"], s["map_sha256"])
                != (s0["traj_sha256"], s0["map_sha256"]) for s in ranks),
            f"{name}: the ranks' trajectories or maps differ: "
            f"{[(s['traj_sha256'], s['map_sha256']) for s in ranks]}")
    fail_if(any(k == 0 for k in k1 + k2),
            f"{name}: a kernel of the path was never launched")
    # the mapping steps replay their segments: no eager step but each
    # signature's warm-up
    maps = [s["graphs"]["map"] for s in ranks]
    fail_if(any(m["eager_steps"] != m["signatures"] or m["segments"] == 0
                or m["replays"] == 0 for m in maps),
            f"{name}: the mapping side's runners {maps}")
    fail_if(any((f, b) != (exp_f, exp_b) for f, b in zip(k1, k2)),
            f"{name}: launches K1 {k1} K2 {k2} by rank, schedule {exp_f} "
            f"{exp_b} a rank")
    ate = res["ate_rmse_m"]
    fail_if(not math.isfinite(ate) or ate > 0.25,
            f"{name}: ATE {ate} not finite or above 0.25 m")
    fail_if(s0["written"].get("ckpt", 0) < 1
            or any(v for s in ranks[1:] for v in s["written"].values()),
            f"{name}: files written by rank {res['written']}")
    ck = sorted(os.listdir(os.path.join(out, "ckpts")))
    fail_if(ck != [f"{n_frames - 1:05d}.npz"], f"{name}: ckpts/ holds {ck}")
    return ranks, res, out


def run_dp(torch, fd, log, n_frames=6, device="cuda", overrides=None):
    """Phase 15: two ranks on cuda:0 through run_torch.py's local launch,
    then the union check (`device` and config `overrides` rehearse it on
    the CPU)."""
    ranks, res, out = _launch_ranks(
        torch, log, "dp", {"data_parallel": True, "mesh_shape": [DP_WORLD]},
        DP_WORLD, n_frames, device, overrides)
    ar = [s["allreduce"] for s in ranks]
    res.update({
        "allreduce_bytes_per_iter": ar[0]["bytes_per_iter"],
        "allreduce_iters": ar[0]["iters"],
        "allreduce_s": [a["seconds"] for a in ar],
        "allreduce_share_of_map": [a["seconds"] / s["timings_s"]["map"]
                                   for a, s in zip(ar, ranks)]})
    log("dp: " + ", ".join(f"{k} {v}" for k, v in res.items()))
    log(f"dp by rank: wall {res['wall_s']} s, map "
        f"{[s['timings_s']['map'] for s in ranks]} s, all_reduce "
        f"{res['allreduce_s']} s, share of map "
        f"{res['allreduce_share_of_map']}")
    res["union"] = check_dp_union(torch, log, out, device)
    return res


# ---------------------------------------------------------------------------
# Phases 18-19: grid-sharded mapping

GS_SHAPE = (2, 2)         # [n_data, n_model] of the union check
# the segment signatures of the long call: (step, stage, segments)
GS_LONG_SIGS = (("gs", "middle", 5), ("gs", "fine", 5), ("gs", "color", 6))


def gs_query_check(torch, dev, gs):
    """The sharded query `gs_eval_points` of 65,536 points (the mesher's
    chunk, over the padded bound) against the dense eval_points on phase
    15's map, and the features summed over `model` from the slabs
    (`gs_feats`) at the same points against the dense trilinear_interp:
    (max abs error over max(1, max |dense|), features bit-equal)."""
    from nice_slam_torch.models.decoders import stage_levels
    from nice_slam_torch.ops.grid import normalize_coords, trilinear_interp
    from nice_slam_torch.parallel import grid_sharded as gsm
    from nice_slam_torch.render import eval_points

    (specs, params, grids, bound, *_) = dp_setup(torch, dev)
    g = torch.Generator(device=dev).manual_seed(11)
    lo, hi = bound[:, 0] - 0.1, bound[:, 1] + 0.1
    pts = lo + (hi - lo) * torch.rand(65536, 3, generator=g, device=dev)
    slabs, shapes = gsm.shard_grids(grids, gs.n_model, gs.m)
    q = gsm.gs_eval_points(params, specs.model, slabs, bound, shapes, pts,
                           "color", gs)
    with torch.no_grad():
        ref = eval_points(params, specs.model, grids, bound, pts, "color")
        levels = stage_levels("color")
        feats = gsm.gs_feats(slabs, bound, pts, shapes, levels, gs, "check")
        p_nor = normalize_coords(pts, bound)
        equal = all(torch.equal(feats[n], trilinear_interp(grids[n], p_nor))
                    for n in levels)
    return (float((q - ref).abs().max()) / max(1.0, float(ref.abs().max())),
            equal)


def gs_union_call(torch, dev, gs, graphs=None, long: bool = False):
    """One mapping call of the gs union check on phase 15's window (the
    middle, fine and colour iterations, no Gauss-Newton: the gs step has
    none) and pixels: with `gs` (a GridShard) this rank's part through
    gs_map_once on `graphs` (None: eagerly), recording a digest of every
    collective's sum and the halo invariant after every step; without,
    this process alone on the union (n_data x the rank's pixels) through
    the dense map_optimize.  `long`: DP_LONG's stages on drawn pixels.
    Returns (sums' digests, params + grids leaves, cams, losses, the
    call's seconds, its collectives' seconds, K1/K2 launches of the call,
    halo checks, whether the call's first feature sum equals the dense
    interpolation bit for bit (None without `gs`))."""
    import dataclasses
    import hashlib

    from nice_slam_torch import mapping
    from nice_slam_torch.graphs import StepGraphs
    from nice_slam_torch.models.decoders import stage_levels
    from nice_slam_torch.ops import fused_decode as fd
    from nice_slam_torch.ops.grid import normalize_coords, trilinear_interp
    from nice_slam_torch.ops.tree import tree_leaves
    from nice_slam_torch.parallel import grid_sharded as gsm

    (specs, params, grids, bound, window, masks, cams0, lr_mask, spec,
     pixels) = dp_setup(torch, dev)
    spec = dataclasses.replace(spec, pose_gn_iters=0)
    stages = DP_STAGES
    if long:
        stages, pixels = DP_LONG, None
    digests, halo_ok, feats_equal, cur = [], [], [], []
    fd.reset_launch_counts()
    _sync(torch, dev)
    t0 = time.perf_counter()
    if gs is None:
        spec = dataclasses.replace(spec, pixels=GS_SHAPE[0] * spec.pixels)
        p, g, cams, losses = mapping.map_optimize(
            params, grids, bound, window, cams0, masks, lr_mask, 1.0,
            specs.camera, stages, spec, specs.render, specs.model,
            ba=True, gen=torch.Generator(device=dev).manual_seed(3),
            pixels=pixels)
        coll_s = 0.0
    else:
        def digest(t):
            digests.append(hashlib.sha256(
                t.detach().cpu().numpy().tobytes()).hexdigest())

        @torch.no_grad()
        def dense_feats(key):
            """The dense interpolation at the points of the step's own
            draws (the runner's held pixels and samples), on the grids the
            call started from: its first feature sum's points."""
            held = runner._buffers[("gs_held", key)]
            b = runner._buffers[key[1]]
            i, j, z = held["i"], held["j"], held["z0"]
            rays_o, rays_d, *_ = mapping._window_rays(
                b.window, b.tree["cams"], specs.camera, i.shape[1],
                pix=(i, j))
            pts = (rays_o[:, None, :] + rays_d[:, None, :] * z[..., None]
                   ).reshape(-1, 3)
            p_nor = normalize_coords(pts, b.bound)
            return torch.cat([trilinear_interp(grids[n], p_nor).reshape(-1)
                              for n in stage_levels(key[2])])

        def model_sum_(t, kind, stage):
            out = gs_sum(t, kind, stage)
            if kind != "check":
                digest(out)
            if kind == "features" and not feats_equal:
                feats_equal.append(torch.equal(out, dense_feats(cur[0])))
            return out

        def reduce_(bucket, kind="gn"):
            rays_reduce(bucket, kind)
            digest(bucket.flat)

        runner = graphs or StepGraphs(dev, capture=False)
        step_segments = runner.step_segments

        def checked(key, *a, **k):
            cur[:] = [key]
            step_segments(key, *a, **k)
            slabs = runner._buffers[key[1]].tree["grids"]
            live = mapping._trained_grids(key[3], ((key[2], 1),))
            halo_ok.extend(gsm.check_halos(
                slabs, [n for n in slabs if n in live], gs))

        gs_sum, rays_reduce = gs.model_sum_, gs.rays.reduce_
        s0 = sum(gs.seconds.values()) + gs.rays.seconds
        gs.model_sum_, gs.rays.reduce_ = model_sum_, reduce_
        runner.step_segments = checked
        try:
            p, g, cams, losses = gsm.gs_map_once(
                params, grids, bound, window, cams0, masks, lr_mask, 1.0,
                specs.camera, stages, spec, specs.render, specs.model, gs,
                gen=torch.Generator(device=dev).manual_seed(3),
                pixels=pixels, graphs=runner)
        finally:
            del gs.model_sum_, gs.rays.reduce_, runner.step_segments
        coll_s = sum(gs.seconds.values()) + gs.rays.seconds - s0
    _sync(torch, dev)
    secs = time.perf_counter() - t0
    counts = fd.launch_counts()
    return (digests, tree_leaves(p) + tree_leaves(g), cams, losses, secs,
            coll_s, (counts["fused_decode_fwd"], counts["fused_decode_bwd"]),
            halo_ok, feats_equal[0] if feats_equal else None)


def gs_rank_main(rank: int, port: int, out: str, device: str) -> int:
    """One rank of the gs union check (chip_smoke.py --gs-rank R --port P
    --out FILE --device D): saves its results and the graphed-against-
    eager checks, as dp_rank_main's."""
    import numpy as np
    import torch

    from nice_slam_torch.graphs import StepGraphs
    from nice_slam_torch.parallel import multihost
    from nice_slam_torch.parallel.grid_sharded import GridShard

    torch.backends.cuda.matmul.allow_tf32 = False
    multihost.initialize(f"127.0.0.1:{port}", GS_SHAPE[0] * GS_SHAPE[1],
                         rank, timeout_s=300, device=device)
    dev = multihost.rank_device(device, rank)
    gs = GridShard(*GS_SHAPE)
    query_err, feats_equal = gs_query_check(torch, dev, gs)
    union = gs_union_call(torch, dev, gs)
    union_g = gs_union_call(torch, dev, gs, graphs=StepGraphs(dev))
    eager, graphed, checked, stats = graphed_against_eager(
        torch, dev, lambda r: gs_union_call(torch, dev, gs, graphs=r,
                                            long=True))
    _, leaves, cams, losses, call_s, _, launches, halo_ok, _ = union
    arrays = {f"leaf{k}": t.detach().cpu().numpy()
              for k, t in enumerate(leaves)}
    arrays.update({
        "cams": cams.detach().cpu().numpy(), "losses": losses.cpu().numpy(),
        "launches": np.array(launches), "feats_equal": np.array(feats_equal),
        # each call's first feature sum against the dense interpolation
        "step_feats_equal": np.array([c[8] for c in (union, union_g, eager,
                                                     graphed)]),
        "halo_ok": np.array(halo_ok, bool), "dm": np.array([gs.d, gs.m]),
        "query_err": np.array(query_err),
        "call_s": np.array(call_s),
        "stats": np.array(json.dumps(gs.stats())),
        "backend": np.array(multihost.backend()),
        "graphed": np.array(json.dumps({
            "union_equal": (_same_call(torch, union, union_g)
                            and union[6:] == union_g[6:]),
            "long_equal": (_same_call(torch, eager, graphed)
                           and eager[6:] == graphed[6:]),
            "union_s": [union[4], union_g[4]],
            "long_s": [eager[4], graphed[4]],
            "long_reduce_s": [eager[5], graphed[5]],
            "reduces": [len(eager[0]), len(graphed[0])],
            "halo_checks": [len(eager[7]), len(graphed[7])],
            "sync_checked": _sig_names(checked), "stats": stats}))})
    np.savez(out, **arrays)
    multihost.shutdown()
    return 0


def check_gs_union(torch, log, device="cuda"):
    """Phase 18: four ranks at [2, 2] of one mapping call over gloo on the
    card against this process on the union: the features summed from the
    slabs bit-equal to the dense interpolation (the first sum of each of
    the rank's four mapping calls at the step's own points, and at the
    query's points),
    every loss within 1e-6 relative, the updated decoders, grids and
    cameras within 1e-5 relative Frobenius, the halo invariant bitwise
    after every step, K1/K2 launches a rank equal to the dense call's, the
    ranks bit-equal; the sharded query within 1e-4 x max(1, max |dense|)
    of eval_points (K1's forward tolerance).  On every rank graphed equals
    eager bit for bit (every collective's sum, leaf, the cameras, the
    losses, the launches and the halo invariant) in the union call and in
    a longer one whose eager run the sync-debug sweep checked."""
    import numpy as np

    from nice_slam_torch.parallel.multihost import free_port, rank_world

    fail_if(rank_world()[1] != 1, "gs: the smoke itself joined a group")
    out_dir = os.path.join(REPO, "output", "chip_smoke_gs_union")
    os.makedirs(out_dir, exist_ok=True)
    world = GS_SHAPE[0] * GS_SHAPE[1]
    _release(torch)
    port = free_port()
    t0 = time.perf_counter()
    procs = [subprocess.Popen(
        [sys.executable, os.path.abspath(__file__), "--gs-rank", str(r),
         "--port", str(port), "--device", device, "--out",
         os.path.join(out_dir, f"rank{r}.npz")],
        cwd=REPO, stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
        text=True) for r in range(world)]
    try:
        logs = [p.communicate(timeout=600)[0] for p in procs]
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
    for r, (p, text) in enumerate(zip(procs, logs)):
        fail_if(p.returncode != 0,
                f"gs union: rank {r} exited {p.returncode}: {text[-3000:]}")
    ranks_s = time.perf_counter() - t0
    dev = torch.device(device)
    _, leaves, cams, losses, _, _, launches, *_ = gs_union_call(torch, dev,
                                                                None)
    want = {f"leaf{k}": t.detach() for k, t in enumerate(leaves)}
    want["cams"] = cams.detach()
    got, graphed = [], []
    for r in range(world):
        with np.load(os.path.join(out_dir, f"rank{r}.npz")) as z:
            got.append({k: z[k] for k in z.files})
        graphed.append(json.loads(str(got[-1].pop("graphed"))))
    worst, loss_err = 0.0, 0.0
    for r, g in enumerate(got):
        fail_if(list(g["dm"]) != [r // GS_SHAPE[1], r % GS_SHAPE[1]],
                f"gs union: rank {r} is (d, m) {list(g['dm'])}")
        fail_if(not float(g["query_err"]) <= 1e-4,
                f"gs union: rank {r}'s sharded query is {g['query_err']} "
                "(relative to max(1, max |dense|)) from eval_points")
        fail_if(not bool(g["feats_equal"]),
                f"gs union: rank {r}'s summed features differ from the "
                "dense interpolation")
        fail_if(not g["step_feats_equal"].all(),
                f"gs union: rank {r}'s step summed features that differ from "
                "the dense interpolation at its own points (union, graphed "
                f"union, long, graphed long: {g['step_feats_equal']})")
        fail_if(graphed[r]["halo_checks"][0] != graphed[r]["halo_checks"][1],
                f"gs union: rank {r}'s halo checks {graphed[r]}")
        fail_if(tuple(g["launches"]) != launches,
                f"gs union: rank {r} launched K1/K2 {tuple(g['launches'])}, "
                f"the dense call {launches}")
        if g["dm"][1] + 1 < GS_SHAPE[1]:
            fail_if(g["halo_ok"].size == 0 or not g["halo_ok"].all(),
                    f"gs union: rank {r}'s halo invariant {g['halo_ok']}")
        lw = losses.cpu().numpy()
        loss_err = max(loss_err, float(np.max(np.abs(g["losses"] - lw)
                                              / np.abs(lw))))
        for k, w in want.items():
            worst = max(worst, _rel_err(torch, torch.as_tensor(g[k]).to(dev),
                                        w))
        for k in want:
            fail_if(not np.array_equal(g[k], got[0][k]),
                    f"gs union: ranks 0 and {r} differ at {k}")
    st = json.loads(str(got[0]["stats"]))
    res = {"ranks": world, "shape": list(GS_SHAPE),
           "backend": str(got[0]["backend"]), "ranks_s": ranks_s,
           "call_s": [float(g["call_s"]) for g in got],
           "launches_a_rank": list(launches), "loss_max_rel_err": loss_err,
           "result_max_rel_err": worst,
           "halo_checks": int(got[0]["halo_ok"].size),
           "query_max_err": max(float(g["query_err"]) for g in got),
           "bytes_per_iter": {k: v for k, v in st["bytes_per_iter"].items()
                              if k != "check"}}
    log("gs union: " + json.dumps(res))
    fail_if(not loss_err <= 1e-6,
            f"gs union: losses {loss_err} relative from the union's")
    fail_if(not worst <= 1e-5,
            f"gs union: results {worst} relative from the union's")
    res["graphed"] = check_graphed_ranks(log, "gs", graphed, GS_LONG_SIGS)
    return res


def run_gs(torch, fd, log, strict_ate, n_frames=6, device="cuda",
           overrides=None):
    """Phase 19: run_torch.py with tpu.grid_sharded [1, 2] (two ranks on
    the card over gloo), strict, full width."""
    ranks, res, _ = _launch_ranks(
        torch, log, "gs", {"grid_sharded": [1, 2]}, 2, n_frames, device,
        overrides)
    st = [s["grid_sharded"] for s in ranks]
    secs = [sum(x["seconds"].values()) for x in st]
    res.update({
        "strict_ate_rmse_m": strict_ate,
        "collective_bytes_per_iter": st[0]["bytes_per_iter"],
        "collective_iters": st[0]["iters"],
        "collective_s_by_kind": [x["seconds"] for x in st],
        "collective_share_of_map": [c / s["timings_s"]["map"]
                                    for c, s in zip(secs, ranks)]})
    log("gs: " + ", ".join(f"{k} {v}" for k, v in res.items()))
    log(f"gs by rank: wall {res['wall_s']} s, map "
        f"{[s['timings_s']['map'] for s in ranks]} s, collectives "
        f"{secs} s, share of map {res['collective_share_of_map']}")
    fail_if(any(x["shape"] != [1, 2] for x in st), "gs: shape")
    return res


def pipelined_schedule(n: int, every: int) -> list:
    """The JAX PipelinedSlamEngine's order of work (nice_slam_tpu/parallel/
    pipelined.py:115-171): event 0, its snapshot; per group, its frames
    tracked, the previous event's snapshot, the boundary's event; the
    final snapshot."""
    seq = [("map", 0), ("snap", None)]
    cur, prev = 1, None
    while cur < n:
        g_end = min(((cur - 1) // every + 1) * every, n - 1)
        seq += [("track", i) for i in range(cur, g_end + 1)]
        if prev is not None:
            seq.append(("snap", prev))
        seq.append(("map", g_end))
        prev, cur = g_end, g_end + 1
    return seq + [("snap", prev)]


class InlineMapper:
    """The sequential order of the pipelined engine's steps: a mapping
    event runs when the loop hands it over, on the loop's thread and
    stream (substituted for parallel/pipelined.py's MapperThread)."""

    def __init__(self, device):
        pass

    def submit(self, job, *held):
        job()

    def join(self):
        pass


def pipe_digest(eng) -> str:
    """sha256 of the trajectory, the decoders, the grids and the keyframe
    store (slots, frames and count)."""
    import hashlib

    kf = eng.store
    h = hashlib.sha256(state_digest(eng).encode())
    for t in (kf.colors, kf.depths, kf.est_c2w, kf.gt_c2w, kf.frame_idx):
        h.update(t.detach().cpu().contiguous().numpy().tobytes())
    h.update(json.dumps([int(kf.count), list(eng.kf_frame_ids)]).encode())
    return h.hexdigest()


def ckpt_digest(out: str) -> dict:
    """{checkpoint file: sha256 of its arrays by name}."""
    import hashlib

    import numpy as np

    res = {}
    for f in sorted(os.listdir(os.path.join(out, "ckpts"))):
        h = hashlib.sha256()
        with np.load(os.path.join(out, "ckpts", f)) as z:
            for k in sorted(z.files):
                h.update(k.encode() + z[k].tobytes())
        res[f] = h.hexdigest()
    return res


def _pipelined_run(torch, fd, log, cfg, name):
    """One pipelined run of cfg on cuda:0 with the order of work recorded
    where the loop fixes it (tracked frames, hand-overs, joins,
    snapshots) and, at each event, the storages the tracker's snapshot and
    trajectory share with the mapper's map, trajectory and keyframes."""
    from nice_slam_torch.ops.tree import tree_leaves
    from nice_slam_torch.parallel.pipelined import PipelinedSlamEngine

    eng = PipelinedSlamEngine(cfg, devices=[torch.device("cuda", 0)])
    fail_if(eng.dev_track != eng.dev_map, "pipelined: two devices")
    seq, shared = [], []
    orig = (eng.track, eng.mapping_event, eng._snapshot, eng._submit_event,
            eng._join_event)

    def ptrs(ts):
        return {t.untyped_storage().data_ptr() for t in ts}

    def track(idx, *a, **k):
        seq.append(("track", idx))
        return orig[0](idx, *a, **k)

    def mapping_event(idx, *a, **k):
        # on the mapper's thread: only this function appends to `shared`
        st, kf = eng.map_state, eng.store
        mapper = ptrs(tree_leaves(st.params) + tree_leaves(st.grids)
                      + [st.bound, kf.est_c2w, kf.colors, kf.depths,
                         eng.map_side()[0]])
        tracker = ptrs(tree_leaves(eng._params_t) + tree_leaves(eng._grids_t)
                       + [eng._bound_t, eng.est_c2w_dev])
        shared.append(len(mapper & tracker))
        return orig[1](idx, *a, **k)

    def snapshot(idx):
        seq.append(("snap", idx))
        return orig[2](idx)

    def submit(idx, *a, **k):
        seq.append(("map", idx))
        return orig[3](idx, *a, **k)

    def join():
        seq.append(("join",))
        return orig[4]()

    (eng.track, eng.mapping_event, eng._snapshot, eng._submit_event,
     eng._join_event) = track, mapping_event, snapshot, submit, join
    n_frames = eng.n_img
    for i in range(n_frames):
        eng.dataset[i]
    _release(torch)
    torch.cuda.reset_peak_memory_stats()
    fd.reset_launch_counts()
    with RunCounters(torch) as rc:
        t0 = time.perf_counter()
        eng.run()
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
    counts = fd.launch_counts()
    tm = eng.timings
    res = {"path": "pipelined", "order": name, "wall_s": wall,
           "frames": n_frames, "frames_per_s": n_frames / wall,
           "track_s": tm["track"], "map_s": tm["map"],
           "overlap_share": (tm["track"] + tm["map"] - wall)
           / min(tm["track"], tm["map"]),
           "ate_rmse_m": eng.ate()["rmse"],
           "peak_mib": torch.cuda.max_memory_allocated() / 2**20,
           "k1": counts["fused_decode_fwd"], "k2": counts["fused_decode_bwd"],
           "shared_storages": shared, "fault3": rc.result,
           "timings": dict(tm), "graphs": graph_info(eng)}
    log(f"pipelined ({name}): " + ", ".join(f"{k} {v}"
                                           for k, v in res.items()))
    return res, seq, eng


def run_pipelined(torch, fd, log, n_frames=16, iters_first=200):
    """Phase 16: the pipelined engine on one card, its mapper on a thread
    and CUDA stream of its own, against the sequential order of the same
    steps (InlineMapper)."""
    from nice_slam_torch.config import load_config
    from nice_slam_torch.parallel import pipelined

    runs = {}
    for name in ("threads", "inline"):
        out = os.path.join(REPO, "output", f"chip_smoke_pipelined_{name}")
        cfg = load_config(SYN_CFG, overrides={
            "synthetic": {"n_frames": n_frames}, "tpu": {"pipelined": True},
            "mapping": {"iters_first": iters_first, "color_refine": False},
            "data": {"output": out}})
        worker = pipelined.MapperThread
        if name == "inline":
            pipelined.MapperThread = InlineMapper
        try:
            res, seq, eng = _pipelined_run(torch, fd, log, cfg, name)
        finally:
            pipelined.MapperThread = worker
        runs[name] = (res, seq, pipe_digest(eng), ckpt_digest(out))
        del eng
        want = pipelined_schedule(n_frames, cfg["mapping"]["every_frame"])
        exp_f, exp_b, _ = expected_launches(cfg, n_frames)
        fail_if([e for e in seq if e[0] != "join"] != want,
                f"pipelined ({name}): order {seq}, schedule {want}")
        fail_if(any(seq[i - 1] != ("join",) for i, e in enumerate(seq)
                    if e[0] == "snap"),
                f"pipelined ({name}): a snapshot before its join: {seq}")
        fail_if(res["k1"] == 0 or res["k2"] == 0,
                f"pipelined ({name}): a kernel of the path was never "
                "launched")
        fail_if((res["k1"], res["k2"]) != (exp_f, exp_b),
                f"pipelined ({name}): launches K1 {res['k1']} K2 "
                f"{res['k2']}, schedule {exp_f} {exp_b}")
        fail_if(any(res["shared_storages"]),
                f"pipelined ({name}): the tracker's snapshot shares storage "
                f"with the mapper's state at events: "
                f"{res['shared_storages']}")
        ate = res["ate_rmse_m"]
        fail_if(not math.isfinite(ate) or ate > 0.35,
                f"pipelined ({name}): ATE {ate} not finite or above 0.35 m")
    (thr, _, d_thr, c_thr), (inl, _, d_inl, c_inl) = (runs["threads"],
                                                      runs["inline"])
    log(f"pipelined: threads {thr['wall_s']:.3f} s, inline "
        f"{inl['wall_s']:.3f} s (ratio {thr['wall_s'] / inl['wall_s']:.4f}); "
        f"overlap share {thr['overlap_share']:.4f} (inline "
        f"{inl['overlap_share']:.4f}); checkpoints {sorted(c_thr)}")
    fail_if(d_thr != d_inl, "pipelined: the threaded run's trajectory, "
            "decoders, grids or keyframes differ from the inline run's")
    fail_if(c_thr != c_inl, "pipelined: the threaded run's checkpoints "
            "differ from the inline run's")
    return {**thr, "inline": {k: inl[k] for k in (
        "wall_s", "track_s", "map_s", "overlap_share", "peak_mib",
        "fault3")}}


def box_sdf(p, lo, hi):
    import numpy as np

    q = np.abs(p - (lo + hi) / 2) - (hi - lo) / 2
    return (np.linalg.norm(np.maximum(q, 0.0), axis=-1)
            + np.minimum(q.max(axis=-1), 0.0))


def synthetic_gt_mesh(spacing: float = 0.02):
    """The ground-truth mesh of SyntheticScene.default(): the room's walls,
    the spheres and the box, as the zero level of a solid field (positive
    outside the room's interior and inside an object) through the port's
    marching tetrahedra.  A fixture of the smoke."""
    import numpy as np

    from nice_slam_torch.native import marching_tetrahedra
    from nice_slam_torch.utils.synthetic import SyntheticScene

    sc = SyntheticScene.default()
    lo = np.asarray(sc.room_lo, float) - 2 * spacing
    hi = np.asarray(sc.room_hi, float) + 2 * spacing
    axes = [np.arange(lo[a], hi[a] + spacing / 2, spacing) for a in range(3)]
    p = np.stack(np.meshgrid(*axes, indexing="ij"), axis=-1)
    f = box_sdf(p, np.asarray(sc.room_lo), np.asarray(sc.room_hi))
    for s in sc.spheres:
        f = np.maximum(f, s.radius - np.linalg.norm(p - s.center, axis=-1))
    for b in sc.boxes:
        f = np.maximum(f, -box_sdf(p, b.lo, b.hi))
    return marching_tetrahedra(f.astype(np.float32), 0.0, lo,
                               np.full(3, spacing))


def run_recon(log, mesh_path, ckpt_path, cam, n_views=50,
              out_dir=None):
    """Phase 17: phase 10's mesh against the synthetic scene's culled GT
    mesh, through the port's tools."""
    import numpy as np

    from nice_slam_torch.native import _rasterize_depth_numpy, rasterize_depth
    from nice_slam_torch.tools import cull_mesh, eval_recon
    from nice_slam_torch.utils.plyio import read_ply, write_ply

    out_dir = out_dir or os.path.join(REPO, "output", "chip_smoke_recon")
    os.makedirs(out_dir, exist_ok=True)
    parts = {}

    def part(name, t0):
        parts[name] = time.perf_counter() - t0
        return time.perf_counter()

    t = t_all = time.perf_counter()
    gv, gt_ = synthetic_gt_mesh()
    gt_path = os.path.join(out_dir, "gt_mesh.ply")
    write_ply(gt_path, gv, gt_)
    t = part("gt_mesh", t)
    culled = os.path.join(out_dir, "gt_mesh_culled.ply")
    cull_mesh.main([gt_path, "--ckpt", ckpt_path, "--traj", "gt",
                    "--output", culled, "--save_unseen",
                    "--H", str(cam["H"]), "--W", str(cam["W"]),
                    "--fx", str(cam["fx"]), "--fy", str(cam["fy"]),
                    "--cx", str(cam["cx"]), "--cy", str(cam["cy"])])
    t = part("cull", t)
    rec, gt = read_ply(mesh_path), read_ply(culled)
    unseen = np.load(culled.replace(".ply", "_pc_unseen.npy"))
    t = part("read", t)
    m3 = eval_recon.calc_3d_metrics(rec, gt)
    t = part("metrics_3d", t)
    m2 = eval_recon.calc_2d_metric(rec, gt, unseen, n_views=n_views)
    t = part("metrics_2d", t)
    self3 = eval_recon.calc_3d_metrics(gt, gt, align=False)
    # the mean distance to the nearest of n uniform samples on an area A
    # is about 0.5 sqrt(A / n)
    v0, v1, v2 = (gt[0][gt[1][:, k]] for k in range(3))
    area = 0.5 * float(np.linalg.norm(np.cross(v1 - v0, v2 - v0),
                                      axis=1).sum())
    floor_cm = 100 * 0.5 * math.sqrt(area / 200_000)
    self2 = eval_recon.calc_2d_metric(gt, gt, unseen, n_views=5,
                                      align=False)
    t = part("self_check", t)
    # the library against its numpy oracle on one view: a GT pose of the
    # run, 10,000 of the reconstruction's triangles
    with np.load(ckpt_path) as z:
        c2w = z["gt_c2w"][int(z["idx"]) // 2]
    rv, rt = rec[0], rec[1]
    sub = rt[np.random.RandomState(0).choice(len(rt), min(10_000, len(rt)),
                                             replace=False)]
    args = (cam["H"], cam["W"], cam["fx"], cam["fy"], cam["cx"], cam["cy"])
    d_lib = rasterize_depth(rv, sub, c2w, *args)
    d_np = _rasterize_depth_numpy(
        np.ascontiguousarray(rv, np.float32), np.asarray(sub, np.int64),
        np.linalg.inv(c2w).astype(np.float32), *args, 0.01, 20.0)
    cover = d_lib > 0
    miss = int((cover != (d_np > 0)).sum())
    both = cover & (d_np > 0)
    rel = float(np.max(np.abs(d_lib - d_np)[both] / d_np[both])) \
        if both.any() else 0.0
    t = part("oracle_view", t)
    res = {"path": "recon", "wall_s": time.perf_counter() - t_all,
           "parts_s": parts, "n_views": n_views,
           "rec_vertices": len(rv), "rec_triangles": len(rt),
           "gt_triangles": len(gt_), "gt_culled_triangles": len(gt[1]),
           "unseen_points": len(unseen), **m3, **m2,
           "self": {**self3, **self2, "sampling_floor_cm": floor_cm},
           "oracle": {"covered_px": int(cover.sum()), "coverage_differs_px":
                      miss, "max_rel_err": rel}}
    log("recon: " + ", ".join(f"{k} {v}" for k, v in res.items()))
    fail_if(not all(math.isfinite(res[k]) for k in (
        "accuracy_cm", "completion_cm", "completion_ratio_pct",
        "depth_l1_cm")), "recon: a metric is not finite")
    fail_if(res["views_used"] == 0, "recon: no view was used")
    # against itself: depth L1 exactly 0; accuracy and completion at the
    # sampling floor (two independent 200k samples of the same surface)
    fail_if(self2["depth_l1_cm"] != 0.0 or self2["views_used"] == 0,
            f"recon: GT against itself, depth L1 {self2}")
    fail_if(not (self3["accuracy_cm"] < 2 * floor_cm
                 and self3["completion_cm"] < 2 * floor_cm
                 and self3["completion_ratio_pct"] > 99.0),
            f"recon: GT against itself {self3}, sampling floor "
            f"{floor_cm} cm")
    fail_if(miss > max(2, cover.sum() // 1000) or not rel <= 1e-4
            or not cover.any(),
            f"recon: rasterizer against its oracle: {res['oracle']}")
    return res


# ---------------------------------------------------------------------------
# Phase 20: visualiser and replay

def state_digest(eng) -> str:
    """sha256 of the trajectory, the decoders and the grids."""
    import hashlib

    from nice_slam_torch.ops.tree import tree_leaves

    h = hashlib.sha256()
    for t in ([eng.est_c2w_dev] + tree_leaves(eng.map_state.params)
              + tree_leaves(eng.map_state.grids)):
        h.update(t.detach().cpu().contiguous().numpy().tobytes())
    return h.hexdigest()


def vis_schedule(cfg, n_img: int):
    """The panels of a strict run by the JAX package's rules: tracking,
    every vis_freq-th tracked frame at every vis_inside_freq-th of its
    iterations; mapping, every single-pass event of a vis_freq-th frame
    but the first (mapping.no_vis_on_first_frame) and the colour
    refinement, at every vis_inside_freq-th of its iterations."""
    t, m = cfg["tracking"], cfg["mapping"]
    tracking = [f"{i:05d}_{it:04d}" for i in range(1, n_img)
                if i % t["vis_freq"] == 0
                for it in range(0, t["iters"], t["vis_inside_freq"])]
    mapping = [f"{e:05d}_{it:04d}"
               for e in map_events(n_img, m["every_frame"], 0)
               if e % m["vis_freq"] == 0 and e != 0
               and not (e == n_img - 1 and m["color_refine"])
               for it in range(0, m["iters"], m["vis_inside_freq"])]
    return tracking, mapping


def panel_kinds(camera, rspec, n_panels: int, chunk: int = 16384) -> dict:
    """K1 launches by kind of n_panels full-image renders (colour stage,
    `chunk` rays a launch, the last chunk partial)."""
    per_ray = rspec.n_samples + rspec.n_surface
    rays = camera.H * camera.W
    kinds = {}
    for s in range(0, rays, chunk):
        key = f"color n={min(chunk, rays - s) * per_ray}"
        kinds[key] = kinds.get(key, 0) + n_panels
    return kinds


def check_panel(torch, fd, eng, cap, npz, log, name):
    """One panel's render through K1 against the same render through the
    plain decode on the card (the launch counts restored afterwards).
    Tolerance: 1e-4 x max(1, max |ref|) for depth and colour at all but
    max(2, H*W / 1000) pixels (ROADMAP.md §3 fault 5: a ReLU that flips
    between the two summation orders).  The kernel's depth must equal the
    panel's npz bit for bit (the captured inputs are the panel's).
    Returns the max abs error over the pixels within tolerance."""
    import dataclasses

    import numpy as np

    from nice_slam_torch.models import decoders
    from nice_slam_torch.render import render_image

    params, grids, bound, c2w, gt_depth = cap
    s = eng.specs
    rspec = dataclasses.replace(s.render, perturb=0.0, train_decoders=False)
    saved = (fd.FusedNiceDecode.fwd_launches, fd.FusedNiceDecode.bwd_launches,
             dict(fd.FusedNiceDecode.fwd_kinds),
             dict(fd.FusedNiceDecode.bwd_kinds))
    out = {}
    for route in ("kernel", "plain"):
        orig = decoders.fused_nice_decode
        if route == "plain":
            decoders.fused_nice_decode = (
                lambda wc, _tw, p, cm, cf, cc, *ws:
                fd.reference_nice_decode(wc, p, cm, cf, cc, *ws))
        try:
            d, _, c = render_image(params, s.model, grids, bound, c2w,
                                   s.camera, rspec, "color", gt_depth)
        finally:
            decoders.fused_nice_decode = orig
        out[route] = (d, c)
    torch.cuda.synchronize()
    (fd.FusedNiceDecode.fwd_launches, fd.FusedNiceDecode.bwd_launches,
     fd.FusedNiceDecode.fwd_kinds, fd.FusedNiceDecode.bwd_kinds) = saved
    fail_if(not np.array_equal(out["kernel"][0].cpu().numpy(), npz["depth"]),
            f"vis: {name}: the re-render differs from the panel's npz")
    n_pix = gt_depth.numel()
    allowed = max(2, n_pix // 1000)
    err = 0.0
    for part, a, ref in (("depth", out["kernel"][0], out["plain"][0]),
                         ("colour", out["kernel"][1], out["plain"][1])):
        tol = 1e-4 * max(1.0, float(ref.abs().max()))
        diff = (a - ref).abs().reshape(n_pix, -1).amax(-1)
        bad = int((~(diff <= tol)).sum())
        fail_if(bad > allowed, f"vis: {name} {part}: {bad} pixels beyond "
                f"{tol} (allowed {allowed})")
        err = max(err, float(diff[diff <= tol].max()))
        log(f"vis: {name} {part} through K1 vs the plain decode: max abs "
            f"err {float(diff[diff <= tol].max()):.3g} (tol {tol:.3g}), "
            f"{bad} pixels beyond (allowed {allowed})")
    return err


def run_replay(log, main_ref):
    """The replay's --html on phase 3's output dir in a subprocess."""
    import base64
    import re

    import numpy as np

    from nice_slam_torch.utils.checkpoint import latest_checkpoint

    run_dir = os.path.join(REPO, "output", "chip_smoke")
    out = os.path.join(REPO, "output", "chip_smoke_vis", "replay.html")
    t0 = time.perf_counter()
    r = subprocess.run([sys.executable, "-m", "nice_slam_torch.tools.replay",
                        run_dir, "--html", out], cwd=REPO,
                       capture_output=True, text=True, timeout=300)
    wall = time.perf_counter() - t0
    fail_if(r.returncode != 0, f"replay: exit {r.returncode}: {r.stderr}")
    with open(out) as f:
        m = re.search(r"const DATA = (\{.*?\});\n", f.read(), re.S)
    fail_if(m is None, "replay: no DATA block in the viewer")
    data = json.loads(m.group(1))
    ckpt = latest_checkpoint(os.path.join(run_dir, "ckpts"))
    with np.load(ckpt) as z:
        est = z["est_c2w"].astype(np.float32)
    n = main_ref["frames"]
    fail_if(data["n"] != n or data["kf"] != main_ref["kf"],
            f"replay: n {data['n']} kf {data['kf']}, phase 3: {n} "
            f"{main_ref['kf']}")
    est_html = np.frombuffer(base64.b64decode(data["est"]),
                             np.float32).reshape(n, 4, 4)
    fail_if(not np.array_equal(est_html, est[:n]),
            f"replay: est differs from {ckpt}'s est_c2w")
    has_mesh = os.path.exists(os.path.join(run_dir, "mesh",
                                           "final_mesh.ply"))
    fail_if(("mesh_v" in data and "mesh_i" in data) != has_mesh,
            f"replay: mesh arrays {'mesh_v' in data}, final_mesh.ply "
            f"{has_mesh}")
    res = {"wall_s": wall, "n": data["n"], "kf": data["kf"],
           "mesh": has_mesh, "ate": data.get("ate"),
           "mib": os.path.getsize(out) / 2**20, "ckpt": ckpt}
    log("replay: " + ", ".join(f"{k} {v}" for k, v in res.items()))
    return res


def run_vis(torch, fd, log, main_ref):
    """Phase 20: the main path's run with per-iteration panels, against
    phase 3's state; the panels through K1 against the plain decode; the
    replay of phase 3's run."""
    import numpy as np

    from nice_slam_torch.engine import SlamEngine
    from nice_slam_torch.ops.tree import tree_map
    from nice_slam_torch.utils.visualizer import have_matplotlib, load_panel

    cfg, n_frames = path_cfg("vis")
    out = cfg["data"]["output"]

    eng = SlamEngine(cfg, device="cuda").enable_visualizer()
    want_t, want_m = vis_schedule(cfg, n_frames)
    fail_if((len(want_t), len(want_m)) != (4, 3),
            f"vis: schedule {want_t} {want_m}, expected 4 + 3 panels")
    # the inputs of one tracking and one mapping panel, for the check
    caps = {}

    def capture(vis, kind, at):
        orig = vis.render_panel

        def render_panel(engine, idx, it, gt_color, gt_depth, c2w,
                         params=None, grids=None, bound=None, **kw):
            if f"{idx:05d}_{it:04d}" == at:
                st = engine.map_state
                caps[kind] = (
                    tree_map(torch.clone, st.params if params is None
                             else params),
                    tree_map(torch.clone, st.grids if grids is None
                             else grids),
                    (engine.bound if bound is None else bound).clone(),
                    torch.as_tensor(c2w).clone(), gt_depth.clone())
            return orig(engine, idx, it, gt_color, gt_depth, c2w,
                        params=params, grids=grids, bound=bound, **kw)

        vis.render_panel = render_panel

    capture(eng._track_vis, "tracking", want_t[-1])
    capture(eng._map_vis, "mapping", want_m[1])
    for i in range(n_frames):
        eng.dataset[i]
    _release(torch)
    torch.cuda.reset_peak_memory_stats()
    fd.reset_launch_counts()
    with RunCounters(torch) as rc:
        t0 = time.perf_counter()
        eng.run()
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
    counts = fd.launch_counts()
    fwd_kinds = fd.fwd_launch_kinds()
    digest = state_digest(eng)
    n_panels = len(want_t) + len(want_m)
    exp_f, exp_b, exp_fk = expected_launches(cfg, n_frames)
    pk = panel_kinds(eng.specs.camera, eng.specs.render, n_panels)
    per_panel = sum(pk.values()) // n_panels
    for k, v in pk.items():
        exp_fk[k] = exp_fk.get(k, 0) + v
    mpl = have_matplotlib()
    names = {d: sorted(os.listdir(os.path.join(out, d)))
             for d in ("tracking_vis", "mapping_vis")}
    exts = (".jpg", ".npz") if mpl else (".npz",)
    vis_s = eng.timings.get("vis", 0.0)
    # the run without panels equals phase 3's (the digest check below,
    # and phase 11's repeat): its wall is this run's less the panels'
    res = {"path": "vis", "wall_s": wall, "wall_without_panels_s":
           wall - vis_s, "strict_wall_s": main_ref["wall"],
           "frames": n_frames, "panels": eng.timer.counts.get("vis", 0),
           "ms_per_panel": 1e3 * vis_s / max(eng.timer.counts["vis"], 1),
           "ate_rmse_m": eng.ate()["rmse"],
           "peak_mib": torch.cuda.max_memory_allocated() / 2**20,
           "k1": counts["fused_decode_fwd"], "k2": counts["fused_decode_bwd"],
           "k1_by_kind": fwd_kinds, "k1_per_panel": per_panel,
           "matplotlib": mpl, "files": names, "fault3": rc.result,
           "timings": dict(eng.timings), "graphs": graph_info(eng)}
    log("vis: " + ", ".join(f"{k} {v}" for k, v in res.items()))
    res["signatures"] = check_graphed(log, "vis", eng, res,
                                      PATH_SIGS["vis"])
    fail_if(names["tracking_vis"] != sorted(n + e for n in want_t
                                           for e in exts)
            or names["mapping_vis"] != sorted(n + e for n in want_m
                                             for e in exts),
            f"vis: panels {names}, schedule {want_t} {want_m} as {exts}")
    fail_if(digest != main_ref["digest"],
            "vis: trajectory, grids or decoders differ from phase 3's run")
    fail_if(res["k1"] == 0 or res["k2"] == 0,
            "vis: a kernel of the path was never launched")
    fail_if((res["k1"], res["k2"], fwd_kinds)
            != (exp_f + sum(pk.values()), exp_b, exp_fk),
            f"vis: launches K1 {res['k1']} {fwd_kinds}, K2 {res['k2']}; "
            f"schedule + {per_panel} a panel: {exp_f + sum(pk.values())} "
            f"{exp_fk}, {exp_b}")
    err = 0.0
    for kind, d, at in (("tracking", "tracking_vis", want_t[-1]),
                        ("mapping", "mapping_vis", want_m[1])):
        npz = load_panel(os.path.join(out, d, at + ".npz"))
        fail_if(not all(np.isfinite(npz[k]).all() for k in npz),
                f"vis: {d}/{at}.npz holds a non-finite value")
        err = max(err, check_panel(torch, fd, eng, caps[kind], npz, log,
                                   f"{d}/{at}"))
    res["max_abs_err"] = err
    res["replay"] = run_replay(log, main_ref)
    del eng, caps
    return res


# ---------------------------------------------------------------------------
# Phases 21-22: real camera datasets (Replica room0, ScanNet scene0000)

ROOM0_CFG = os.path.join(REPO, "configs", "Replica", "room0.yaml")
SCENE0000_CFG = os.path.join(REPO, "configs", "ScanNet", "scene0000.yaml")
# a 4:2:0 JPEG 61 pixels wide, written by cv2.imwrite (libjpeg-turbo
# 3.1.2), and the sha256 of cv2.imread's pixels (converted to RGB)
CODEC_JPEG = os.path.join(REPO, "tests", "data", "codec_420_61x45.jpg")
CODEC_JPEG_SHA256 = ("9987da55e8f0482a605fb8ea1e52ed47"
                     "70561d43eceb21c17734bb602c7d0713")


def _flip_yz(c2w):
    """The internal (-y, -z) camera convention <-> the datasets' one."""
    m = c2w.astype("float64").copy()
    m[:3, 1] *= -1
    m[:3, 2] *= -1
    return m


def room0_scene():
    """A room inside room0's bound ([[-2.9, 8.9], [-3.2, 5.5], [-3.5,
    3.3]]), the scene of tests/test_configs_e2e.py:40-57."""
    import numpy as np

    from nice_slam_torch.utils.synthetic import Sphere, SyntheticScene

    light = np.array([0.4, 0.8, 0.45])
    return SyntheticScene(
        room_lo=np.array([-2.0, -2.5, -3.0]),
        room_hi=np.array([2.0, 0.5, 1.0]),
        spheres=[Sphere(np.array([-1.0, -1.9, -1.8]), 0.6,
                        np.array([0.85, 0.25, 0.2])),
                 Sphere(np.array([1.0, -1.7, 0.0]), 0.7,
                        np.array([0.2, 0.45, 0.85]))],
        boxes=[], wall_albedo=np.array([0.7, 0.68, 0.65]),
        light_dir=light / np.linalg.norm(light))


def write_replica_fixture(root, n_frames, cam):
    """Replica's file layout, written by the port's own writers:
    results/frame%06d.jpg (baseline 4:2:0, quality 95),
    results/depth%06d.png (16-bit at the config's png_depth_scale) and
    traj.txt (row-major 4x4 camera-to-world poses in the dataset's
    convention), rendered from room0_scene() at the camera `cam`
    (replica.yaml's 680 x 1200, f 600)."""
    import numpy as np

    from nice_slam_torch.utils.imageio import write_jpeg, write_png
    from nice_slam_torch.utils.synthetic import (
        orbit_trajectory, render_frame)

    res = os.path.join(root, "results")
    os.makedirs(res, exist_ok=True)
    scene = room0_scene()
    poses = orbit_trajectory(scene, n_frames)
    lines = []
    for i in range(n_frames):
        color, depth = render_frame(scene, poses[i], cam["H"], cam["W"],
                                    cam["fx"], cam["fy"], cam["cx"],
                                    cam["cy"])
        write_jpeg(os.path.join(res, f"frame{i:06d}.jpg"),
                   (color * 255).astype(np.uint8), quality=95)
        write_png(os.path.join(res, f"depth{i:06d}.png"),
                  (depth * cam["png_depth_scale"]).astype(np.uint16))
        lines.append(" ".join(map(str, _flip_yz(poses[i]).reshape(-1))))
    with open(os.path.join(root, "traj.txt"), "w") as fh:
        fh.write("\n".join(lines) + "\n")


def write_scannet_fixture(root, n_frames, cam):
    """ScanNet's file layout, written by the port's own writers:
    frames/color/N.jpg, frames/depth/N.png (16-bit millimetres) and
    frames/pose/N.txt, rendered from the synthetic scene (a 4 x 3 x 4 m
    room, inside scene0000's bound) at the camera `cam` (scannet.yaml's
    H, W and intrinsics)."""
    import numpy as np

    from nice_slam_torch.utils.imageio import write_jpeg, write_png
    from nice_slam_torch.utils.synthetic import (
        SyntheticScene, orbit_trajectory, render_frame)

    sub = {k: os.path.join(root, "frames", k)
           for k in ("color", "depth", "pose")}
    for d in sub.values():
        os.makedirs(d, exist_ok=True)
    scene = SyntheticScene.default()
    poses = orbit_trajectory(scene, n_frames)
    for i in range(n_frames):
        color, depth = render_frame(scene, poses[i], cam["H"], cam["W"],
                                    cam["fx"], cam["fy"], cam["cx"],
                                    cam["cy"])
        write_jpeg(os.path.join(sub["color"], f"{i}.jpg"),
                   (color * 255).astype(np.uint8), quality=95)
        write_png(os.path.join(sub["depth"], f"{i}.png"),
                  (depth * cam["png_depth_scale"]).astype(np.uint16))
        np.savetxt(os.path.join(sub["pose"], f"{i}.txt"),
                   _flip_yz(poses[i]))


def check_codec(log):
    """The port's JPEG decoder on this machine: the committed 4:2:0 file
    decodes to the pixels cv2.imread gave where it was written."""
    import hashlib

    from nice_slam_torch.utils.imageio import imread_color

    img = imread_color(CODEC_JPEG)
    digest = hashlib.sha256(img.tobytes()).hexdigest()
    log(f"codec: {os.path.relpath(CODEC_JPEG, REPO)} {img.shape} sha256 "
        f"{digest} (cv2's {CODEC_JPEG_SHA256})")
    fail_if(digest != CODEC_JPEG_SHA256,
            "codec: the JPEG decode differs from cv2.imread's")
    return digest


def cv2_cross_check(log, ds):
    """Where OpenCV imports (the port and this script need none), the
    port's decode of the dataset's files against cv2.imread: printed, not
    a gate, since another libjpeg build may round otherwise."""
    try:
        import cv2
    except ImportError:
        log("cv2: does not import here; no cross-check")
        return None
    import numpy as np

    from nice_slam_torch.utils.imageio import imread_color, imread_depth

    color = sum(np.array_equal(imread_color(p), cv2.cvtColor(
        cv2.imread(p), cv2.COLOR_BGR2RGB)) for p in ds.color_paths)
    depth = sum(np.array_equal(imread_depth(p), cv2.imread(
        p, cv2.IMREAD_UNCHANGED)) for p in ds.depth_paths)
    res = {"version": cv2.__version__, "files": len(ds.color_paths),
           "color_equal": color, "depth_equal": depth}
    log(f"cv2 {cv2.__version__} imports here: the port's decode equals "
        f"its imread for {color}/{len(ds.color_paths)} colour and "
        f"{depth}/{len(ds.depth_paths)} depth files")
    return res


def run_dataset(torch, fd, log, name, cfg_path, writer, n_frames=6):
    """Phases 21-22: a fixture in the dataset's file layout, then the
    shipped scene config, unchanged, through run_torch.py's command line
    and config path with only --input_folder, --output and --frames
    given; strict, full width, no mesh."""
    import shutil

    import numpy as np

    import run_torch
    from nice_slam_torch.engine import SlamEngine
    from nice_slam_torch.utils.imageio import imread_color, imread_depth

    data = os.path.join(REPO, "output", f"chip_smoke_{name}_data")
    out = os.path.join(REPO, "output", f"chip_smoke_{name}")
    shutil.rmtree(data, ignore_errors=True)
    args = run_torch.build_parser().parse_args(
        [cfg_path, "--input_folder", data, "--output", out,
         "--frames", str(n_frames)])
    cfg = run_torch.run_config(args)
    t0 = time.perf_counter()
    writer(data, n_frames, cfg["cam"])
    fixture_s = time.perf_counter() - t0

    eng = SlamEngine(cfg, device="cuda")
    ds = eng.dataset
    fail_if(len(ds) != n_frames or not ds.transfer_color_uint8,
            f"{name}: {len(ds)} frames read, transfer_color_uint8 "
            f"{ds.transfer_color_uint8}")
    # host cost a frame: the decode alone (JPEG + PNG), the whole reader
    t0 = time.perf_counter()
    for i in range(n_frames):
        imread_color(ds.color_paths[i])
        imread_depth(ds.depth_paths[i])
    decode_ms = (time.perf_counter() - t0) * 1e3 / n_frames
    t0 = time.perf_counter()
    for i in range(n_frames):
        _, color, depth, _ = ds[i]
    reader_ms = (time.perf_counter() - t0) * 1e3 / n_frames
    fail_if(not (np.isfinite(color).all() and np.isfinite(depth).all()),
            f"{name}: the reader gave a non-finite value")
    up_u8 = color.size + depth.nbytes
    up_f32 = color.size * 4 + depth.nbytes
    cv2_check = cv2_cross_check(log, ds)

    _release(torch)
    torch.cuda.reset_peak_memory_stats()
    fd.reset_launch_counts()
    t0 = time.perf_counter()
    eng.run(n_frames=args.frames)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    counts = fd.launch_counts()
    fwd_kinds, bwd_kinds = fd.fwd_launch_kinds(), fd.bwd_launch_kinds()
    exp_f, exp_b, exp_fk = expected_launches(cfg, n_frames)
    res = {"path": name, "config": os.path.relpath(cfg_path, REPO),
           "frames": n_frames, "hw": list(color.shape[:2]),
           "wall_s": wall, "frames_per_s": n_frames / wall,
           "timings": {k: eng.timings[k] for k in ("track", "map", "io",
                                                   "ckpt")},
           "ate_rmse_m": eng.ate()["rmse"],
           "peak_mib": torch.cuda.max_memory_allocated() / 2**20,
           "k1": counts["fused_decode_fwd"], "k2": counts["fused_decode_bwd"],
           "k1_by_kind": fwd_kinds, "k2_by_kind": bwd_kinds,
           "decode_ms_per_frame": decode_ms,
           "reader_ms_per_frame": reader_ms,
           "upload_bytes_per_frame": {"uint8": up_u8, "f32": up_f32},
           "fixture_s": fixture_s, "cv2": cv2_check,
           "graphs": graph_info(eng)}
    log(f"{name}: " + ", ".join(f"{k} {v}" for k, v in res.items()))
    fail_if(res["k1"] == 0 or res["k2"] == 0,
            f"{name}: a kernel of the path was never launched")
    fail_if((res["k1"], res["k2"], fwd_kinds) != (exp_f, exp_b, exp_fk),
            f"{name}: launches K1 {res['k1']} {fwd_kinds}, K2 {res['k2']}; "
            f"schedule {exp_f} {exp_fk}, {exp_b}")
    fail_if(not math.isfinite(res["ate_rmse_m"]),
            f"{name}: ATE {res['ate_rmse_m']} not finite")
    del eng
    return res


# ---------------------------------------------------------------------------
# Phase 4: timing

def cuda_time_ms(torch, fn, warmup=3, reps=9, inner=10):
    """Median over `reps` of the device time of `inner` back-to-back calls,
    divided by `inner` (so the host's enqueue time of one call hides
    behind the device's work on the ones before it)."""
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    times = []
    for _ in range(reps):
        a = torch.cuda.Event(enable_timing=True)
        b = torch.cuda.Event(enable_timing=True)
        a.record()
        for _ in range(inner):
            fn()
        b.record()
        b.synchronize()
        times.append(a.elapsed_time(b) / inner)
    return statistics.median(times)


def _bounds(res, work):
    tc, simt, nbytes = work
    res["bound_ms"], res["bound_by"] = bound_ms(tc, simt, nbytes)
    res["design_bound_ms"], res["design_bound_by"] = bound_ms(
        tc, simt, nbytes, tensor_cores=True)
    return res


def time_fwd(torch, fd, ws, dev, n, with_color, log):
    """K1's launches alone (the C entry with its buffers allocated once:
    the decoder kernel and the occupancy sum), the wrapper as the forward
    calls it (image build, allocation, launches), and the plain version."""
    p, cm, cf, cc, _ = make_inputs(torch, n, 99, dev)
    cc_in = cc if with_color else cm
    img = fd.build_image(ws)
    lib = fd._kernels()
    args, out, scratch = fd._fwd_prepare(with_color, p, cm, cf, cc_in, img)
    with torch.no_grad():
        res = {"ms": cuda_time_ms(torch, lambda: lib.nice_decode_fwd(*args)),
               "wrapper_ms": cuda_time_ms(torch, lambda: fd._launch_fwd(
                   with_color, p, cm, cf, cc_in, fd.build_image(ws))),
               "plain_ms": cuda_time_ms(
                   torch, lambda: fd.reference_nice_decode(
                       with_color, p, cm, cf, cc_in, *ws), inner=1)}
    del out, scratch
    _bounds(res, decode_work(n, with_color, "fwd"))
    res.update({"n": n, "stage": "color" if with_color else "fine"})
    log(f"timing K1 n={n} {res['stage']}: "
        + ", ".join(f"{k} {v}" for k, v in res.items()))
    return res


def time_bwd(torch, fd, ws, dev, n, with_color, live, log):
    """K2's launches alone (the C entry with its buffers allocated once:
    the decoder kernels and, with live decoders, the weight-gradient
    reduction), the wrapper around it as the backward calls it
    (allocation, launches, dp sum; the image comes from the forward), and
    the plain version."""
    p, cm, cf, cc, go = make_inputs(torch, n, 99, dev)
    cc_in = cc if with_color else cm
    img = fd.build_image(ws)
    lib = fd._bwd_kernels()
    args, outs, scratch = fd._bwd_prepare(with_color, live, p, cm, cf,
                                          cc_in, go, img)
    with torch.no_grad():
        res = {"ms": cuda_time_ms(torch, lambda: lib.nice_decode_bwd(*args)),
               "wrapper_ms": cuda_time_ms(torch, lambda: fd._launch_bwd(
                   with_color, live, p, cm, cf, cc_in, go, img)),
               "plain_ms": cuda_time_ms(
                   torch, lambda: fd.plain_nice_decode_bwd(
                       with_color, live, p, cm, cf, cc_in, go, ws), inner=1)}
    del outs, scratch
    _bounds(res, decode_work(n, with_color, "bwd", live))
    res.update({"n": n, "stage": "color" if with_color else "fine",
                "live": live})
    log(f"timing K2 n={n} {res['stage']} live={live}: "
        + ", ".join(f"{k} {v}" for k, v in res.items()))
    return res


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    # one rank of phase 15's union check, started by the smoke itself
    ap.add_argument("--dp-rank", type=int, default=None, help=argparse.SUPPRESS)
    # one rank of phase 18's union check
    ap.add_argument("--gs-rank", type=int, default=None, help=argparse.SUPPRESS)
    ap.add_argument("--port", type=int, default=None, help=argparse.SUPPRESS)
    ap.add_argument("--out", default=None, help=argparse.SUPPRESS)
    ap.add_argument("--device", default="cuda", help=argparse.SUPPRESS)
    args = ap.parse_args()
    if args.dp_rank is not None:
        return dp_rank_main(args.dp_rank, args.port, args.out, args.device)
    if args.gs_rank is not None:
        return gs_rank_main(args.gs_rank, args.port, args.out, args.device)
    t_start = time.perf_counter()

    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device", file=sys.stderr)
        return 1
    try:
        from nice_slam_torch.models.decoders import ModelSpec, init_model
        from nice_slam_torch.models.pretrain import load_npz_decoders
        from nice_slam_torch.ops import cuda_build
        from nice_slam_torch.ops import fused_decode as fd
    except ImportError as e:
        print(f"chip_smoke: cannot import the port: {e}", file=sys.stderr)
        return 1

    def log(msg):
        print(msg, flush=True)

    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True).stdout.strip().splitlines()[0]
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    dev = torch.device("cuda", 0)
    log(f"torch {torch.__version__} cuda {torch.version.cuda} "
        f"device {torch.cuda.get_device_name(0)}")

    t0 = time.perf_counter()
    logs = cuda_build.build_all()
    log(f"kernel build: {time.perf_counter() - t0:.2f} s")
    for name, text in logs.items():
        for line in text.splitlines():
            if any(k in line for k in ("registers", "spill", "smem",
                                       "Function properties")):
                log(f"  [{name}] {line.strip()}")
    log(f"K1: {fd.fwd_variant_info()}")
    for live in (False, True):
        for d, name in enumerate(DECS):
            log(f"K2 variant {'live' if live else 'frozen'} {name}: "
                f"{fd.bwd_variant_info(live, d)}")

    ws = [w.contiguous() for w in fd.pack_nice_weights(load_npz_decoders(
        os.path.join(REPO, "pretrained", "decoders_tpu.npz"),
        init_model(torch.Generator(device=dev).manual_seed(0), ModelSpec(),
                   device=dev)))]
    # the new paths' shapes: the occupancy proxy's refresh (the middle
    # grid's nodes, fine), pretraining (4,096 fine, middle and fine
    # live) and the GN of the colour refinement (10 x 200 x 48 colour)
    from nice_slam_torch.config import load_config
    from nice_slam_torch.ops.grid import grid_shape_for_bound
    from nice_slam_torch.state import pad_bound

    syn = load_config(SYN_CFG)
    n_proxy = math.prod(grid_shape_for_bound(
        pad_bound(syn["mapping"]["bound"],
                  syn["grid_len"]["bound_divisible"]),
        syn["grid_len"]["middle"]))
    err_f, err_b = check_kernels(
        torch, fd, ws, dev, log,
        extra=((n_proxy, False, "none", 0, False),
               (4096, False, "middle+fine", 3, True),
               (96000, True, "none", 0, True),
               (240000, True, "color", 4, True),
               (240000, True, "none", 0, True),
               (240000, False, "none", 0, True)))

    counts, fwd_kinds, kinds, eng, strict_ate, wall = run_main_path(
        torch, fd, log)
    # phase 20 holds its run against this state (before phase 4 moves it)
    main_ref = {"digest": state_digest(eng), "wall": wall,
                "frames": eng.frames_done, "kf": list(eng.kf_frame_ids)}
    mesh = run_mesh(torch, fd, eng, log)
    # K1 at the mesh's shapes against the plain version
    for kind in mesh["k1_by_kind"]:
        stage, n = kind.split(" n=")
        e = check_fwd(torch, fd, ws, int(n), stage == "color",
                      make_inputs(torch, int(n), 77, dev)[:4])
        log(f"kernel check K1 {kind} (mesh): ok (fwd err {e:.3g})")
        err_f = max(err_f, e)
    busy = profile_window(torch, eng, log)

    # K1 at the main path's three shapes, then at the mesh's
    fwd_shapes = []
    for path, launches in (
            ("strict", {k: fwd_kinds[k] for k in (
                "color n=48000", "fine n=48000", "color n=9600")}),
            ("mesh", mesh["k1_by_kind"])):
        for kind, count in launches.items():
            stage, n = kind.split(" n=")
            r = time_fwd(torch, fd, ws, dev, int(n), stage == "color", log)
            fwd_shapes.append({**r, "path": path, "launches": count})
    k1 = fwd_shapes[0]
    # K2 at the main path's four shapes, then the shape of the timing
    # before its redesign (48,000 colour, all three decoders live)
    shapes = [time_bwd(torch, fd, ws, dev, n, wc, live, log)
              for n, wc, live in ((48000, True, 4), (48000, True, 0),
                                  (48000, False, 0), (9600, True, 0),
                                  (48000, True, 7))]
    k2 = shapes[4]
    # the strict engine is done with: later phases start without it
    del eng

    loose, loose_cfg = run_lagged(torch, fd, log, "loose", 11)
    free, _ = run_lagged(torch, fd, log, "free", 12)
    resumed = run_resume(torch, fd, log, loose_cfg, 11)
    imap = run_imap(torch, fd, log)
    repeat = run_repeat(torch, fd, log)
    reduced = run_reduced(torch, fd, log)
    modes = run_reduced_modes(torch, fd, log)
    gn = run_gn(torch, fd, log)
    occ = run_occ(torch, fd, log, strict_ate)
    pre = run_pretrain(torch, fd, log, dev)
    dp = run_dp(torch, fd, log)
    pipe = run_pipelined(torch, fd, log)
    recon = run_recon(
        log, os.path.join(REPO, "output", "chip_smoke", "mesh",
                          "final_mesh.ply"),
        os.path.join(REPO, "output", "chip_smoke", "ckpts", "00010.npz"),
        syn["cam"])
    # phases 18-19: grid-sharded mapping (the two-card repairs of the
    # launch path cannot run on one card)
    gs_union = check_gs_union(torch, log)
    gs = run_gs(torch, fd, log, strict_ate)
    gs["union"] = gs_union
    log("gs: the kernels' per-device shared-memory attribute and device "
        f"guard are not exercised here ({torch.cuda.device_count()} card)")
    vis = run_vis(torch, fd, log, main_ref)
    # phases 21-22: the published Replica and ScanNet configs over
    # fixtures in their datasets' file layouts
    check_codec(log)
    replica = run_dataset(torch, fd, log, "replica", ROOM0_CFG,
                          write_replica_fixture)
    scannet = run_dataset(torch, fd, log, "scannet", SCENE0000_CFG,
                          write_scannet_fixture)
    by_path = {r["path"]: r for r in (loose, free, resumed, imap, mesh,
                                      repeat, reduced, *modes.values(), gn,
                                      occ, pre, dp, pipe, gs, vis, replica,
                                      scannet)}
    # K1 at the panels' shapes against the plain version
    vis_kinds = sorted(k for k in vis["k1_by_kind"]
                       if k not in fwd_kinds)
    for kind in vis_kinds:
        n = int(kind.split(" n=")[1])
        e = check_fwd(torch, fd, ws, n, True,
                      make_inputs(torch, n, 78, dev)[:4])
        log(f"kernel check K1 {kind} (panel): ok (fwd err {e:.3g})")
        err_f = max(err_f, e)

    # phase 5 continued: K1 and K2 at the new paths' shapes
    for path, kind in (("occ", f"fine n={n_proxy}"),
                       ("pretrain", "fine n=4096"),
                       ("gn", "color n=96000"),
                       *(("vis", k) for k in vis_kinds),
                       ("scannet", "color n=240000"),
                       ("scannet", "fine n=240000")):
        stage, n = kind.split(" n=")
        r = time_fwd(torch, fd, ws, dev, int(n), stage == "color", log)
        fwd_shapes.append({**r, "path": path, "launches":
                           by_path[path]["k1_by_kind"].get(kind, 0)})
    for path, kind, wc, live in (
            ("pretrain", "fine wgrad n=4096", False, 3),
            ("gn", "color no-wgrad n=96000", True, 0),
            ("scannet", "color wgrad n=240000", True, 4),
            ("scannet", "color no-wgrad n=240000", True, 0),
            ("scannet", "fine no-wgrad n=240000", False, 0)):
        n = int(kind.split(" n=")[1])
        r = time_bwd(torch, fd, ws, dev, n, wc, live, log)
        shapes.append({**r, "path": path, "launches":
                       by_path[path]["k2_by_kind"].get(kind, 0)})

    def paths(key):
        return {"strict": counts[key],
                **{p: r["k1" if key == "fused_decode_fwd" else "k2"]
                   for p, r in by_path.items()}}

    kernels = [
        {"name": "fused_decode_fwd", "route": "cuda",
         "source": "nice_slam_torch/csrc/fused_decode.cu",
         "replaces": "nice_slam_tpu/ops/pallas/fused_decode.py:274",
         "launches": counts["fused_decode_fwd"], "max_abs_err": err_f,
         "ms": k1["ms"], "plain_ms": k1["plain_ms"],
         "bound_ms": k1["bound_ms"], "bound_by": k1["bound_by"],
         "library_ms": None, "design_bound_ms": k1["design_bound_ms"],
         "launches_by_kind": fwd_kinds,
         "launches_by_path": paths("fused_decode_fwd"),
         "shapes": fwd_shapes},
        {"name": "fused_decode_bwd", "route": "cuda",
         "source": "nice_slam_torch/csrc/fused_decode_bwd.cu",
         "replaces": "nice_slam_tpu/ops/pallas/fused_decode.py:304",
         "launches": counts["fused_decode_bwd"], "max_abs_err": err_b,
         "ms": k2["ms"], "plain_ms": k2["plain_ms"],
         "bound_ms": k2["bound_ms"], "bound_by": k2["bound_by"],
         "library_ms": None, "design_bound_ms": k2["design_bound_ms"],
         "launches_by_kind": kinds,
         "launches_by_path": paths("fused_decode_bwd"), "shapes": shapes},
    ]
    log(f"busy share of one frame + event (phase 4): {busy}; phase 3 "
        f"wall {wall:.3f} s, phase 11 walls {repeat['wall_s']} (graphed, "
        f"eager, graphed), phase 16 threads / inline "
        f"{pipe['wall_s'] / pipe['inline']['wall_s']:.4f}")
    log(f"grid scatter: {json.dumps(repeat['scatter'])}")
    log(f"recon: {json.dumps(recon)}")
    log(f"smoke wall: {time.perf_counter() - t_start:.1f} s (the kernels' "
        "build included)")
    print(smi)
    print(json.dumps({"kernels": kernels}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    try:
        sys.exit(main())
    except SmokeFailure as e:
        print(f"chip_smoke FAILED: {e}", file=sys.stderr)
        sys.exit(1)
