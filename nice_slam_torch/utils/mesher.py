"""Mesh extraction (src/utils/Mesher.py), as in the JAX package
(nice_slam_tpu/utils/mesher.py), on tensors of an explicit device:

1. a uniform query grid over marching_cubes_bound + 0.05 padding at
   `resolution` points per axis (Mesher.py:321-347);
2. occupancy decoded on the map's device in chunks of `points_chunk`
   points through `render.eval_points` (the 'fine' stage, middle + fine
   occupancy, which on the card is the fused decode's forward kernel;
   iMAP*: the density), with no autograd graph kept;
3. visibility: a point is seen when it projects into some keyframe
   (Mesher.py:53-212), and a convex hull of the backprojected keyframe
   depth and camera centres, scaled 1.02, bounds the scene (scipy, on the
   host; Mesher.py:214-279);
4. the iso-surface by marching tetrahedra (nice_slam_torch/native, host
   C++);
5. cleaning: faces outside the hull or unseen are culled, small connected
   components dropped (scipy csgraph; Mesher.py:469-510);
6. vertex colours by a direct query of the colour decoder (NICE;
   Mesher.py:513-524) or a short ray along each vertex normal (iMAP*;
   Mesher.py:526-553); a binary PLY file.
"""

from __future__ import annotations

import os
import time
from dataclasses import dataclass
from dataclasses import replace as dc_replace
from typing import Optional

import numpy as np
import torch
from scipy.sparse import coo_matrix
from scipy.sparse.csgraph import connected_components
from scipy.spatial import Delaunay, QhullError

from nice_slam_torch.camera import Camera
from nice_slam_torch.keyframes import project_points
from nice_slam_torch.mapping import bilinear_sample_2d
from nice_slam_torch.models.decoders import ModelSpec
from nice_slam_torch.native import marching_tetrahedra
from nice_slam_torch.render import RenderSpec, eval_points, render_rays
from nice_slam_torch.utils.plyio import write_ply


@dataclass
class MeshSpec:
    resolution: int = 256
    level_set: float = 0.0
    clean_mesh: bool = True
    depth_test: bool = False
    get_largest_components: bool = False
    remove_small_geometry_threshold: float = 0.2
    mesh_bound_scale: float = 1.02
    points_chunk: int = 65536
    color: bool = True
    # 'show_forecast' / mesh_coarse_level: unseen-but-in-hull space gets
    # occupancy from the coarse (scene completion) level + 0.2 and is
    # painted cyan (reference Mesher.py:386-418, 559-565)
    forecast: bool = False


@torch.no_grad()
def _eval_volume_chunked(params, mspec: ModelSpec, grids, bound,
                         pts: torch.Tensor, stage: str, chunk: int,
                         cols) -> torch.Tensor:
    """Columns `cols` of eval_points' raw (N, 4) at pts (N, 3), decoded in
    chunks of `chunk` points (the last one ragged).  Chunks start at
    multiples of 4 rows, so each chunk's points stay 16-byte aligned for
    the fused decode's kernel."""
    if chunk % 4:
        raise ValueError(f"points_chunk must be a multiple of 4, got {chunk}")
    return torch.cat([
        eval_points(params, mspec, grids, bound, pts[lo:lo + chunk], stage,
                    train_decoders=False)[:, cols]
        for lo in range(0, pts.shape[0], chunk)])


@torch.no_grad()
def _seen_mask_chunked(pts: torch.Tensor, kf_c2w: torch.Tensor,
                       kf_depth: torch.Tensor, camera: Camera, chunk: int,
                       depth_test: bool) -> torch.Tensor:
    """Seen = projects inside some keyframe's frustum (reference
    point_masks; with depth_test also requires agreement with that
    keyframe's depth within 2.4 m, Mesher.py:96-142).  kf_c2w (K, 4, 4) and
    kf_depth (K, H, W) hold the keyframes to test.  Returns (N,) bool."""
    out = []
    for lo in range(0, pts.shape[0], chunk):
        u, v, z = project_points(pts[lo:lo + chunk], kf_c2w, camera)
        m = ((u < camera.W) & (u > 0) & (v < camera.H) & (v > 0) & (z < 0))
        if depth_test:
            d_at = torch.stack([bilinear_sample_2d(d, uk, vk)
                                for d, uk, vk in zip(kf_depth, u, v)])
            m = m & (-z <= d_at + 2.4) & (d_at - 2.4 <= -z)
        out.append(torch.any(m, dim=0))
    return torch.cat(out)


def _hull_mask(pts: np.ndarray, kf_c2w: np.ndarray, kf_depth: np.ndarray,
               camera: Camera, scale: float) -> Optional[np.ndarray]:
    """Convex-hull containment of backprojected keyframe depth clouds +
    camera centres, scaled about its centroid (reference
    get_bound_from_frames, Mesher.py:214-279, whose scene bound is also the
    convex hull of the fused surface points and the camera centres).
    None when there is no depth or the cloud is degenerate."""
    cloud = []
    step = 8
    jj, ii = np.meshgrid(np.arange(0, camera.H, step),
                         np.arange(0, camera.W, step), indexing="ij")
    dirs = np.stack([(ii - camera.cx) / camera.fx,
                     -(jj - camera.cy) / camera.fy,
                     -np.ones_like(ii, np.float64)], -1)
    for c2w, depth in zip(kf_c2w, kf_depth):
        d = depth[::step, ::step]
        ok = d > 0
        if not ok.any():
            continue
        pts_cam = dirs[ok] * d[ok][:, None]
        pts_w = pts_cam @ c2w[:3, :3].T + c2w[:3, 3]
        cloud.append(pts_w)
        cloud.append(c2w[None, :3, 3])
    if not cloud:
        return None
    cloud = np.concatenate(cloud, axis=0)
    centroid = cloud.mean(axis=0)
    cloud = (cloud - centroid) * scale + centroid
    try:
        tri = Delaunay(cloud[np.random.RandomState(0).choice(
            len(cloud), min(len(cloud), 20000), replace=False)])
    except (QhullError, ValueError):  # degenerate geometry
        return None
    return tri.find_simplex(pts) >= 0


def _component_filter(verts: np.ndarray, tris: np.ndarray,
                      keep_largest: bool, area_threshold: float):
    """Drop small connected components (reference Mesher.py:469-510)."""
    if len(tris) == 0:
        return tris
    nv = len(verts)
    e = np.concatenate([tris[:, [0, 1]], tris[:, [1, 2]], tris[:, [2, 0]]])
    adj = coo_matrix((np.ones(len(e)), (e[:, 0], e[:, 1])), shape=(nv, nv))
    _, labels = connected_components(adj, directed=False)
    face_label = labels[tris[:, 0]]

    v0, v1, v2 = verts[tris[:, 0]], verts[tris[:, 1]], verts[tris[:, 2]]
    areas = 0.5 * np.linalg.norm(np.cross(v1 - v0, v2 - v0), axis=1)
    comp_area = np.bincount(face_label, weights=areas)
    if keep_largest:
        keep = face_label == np.argmax(comp_area)
    else:
        keep = comp_area[face_label] >= area_threshold
    return tris[keep]


@torch.no_grad()
def _imap_normal_colors(params, mspec: ModelSpec, grids, bound,
                        verts: np.ndarray, tris: np.ndarray,
                        chunk: int) -> np.ndarray:
    """Vertex colours for the iMAP* mode: render a ray from 0.3 m outside
    each vertex along its (area-weighted) normal back through it and take
    the composited colour (reference Mesher.py:526-553).  No jitter and no
    importance samples, so nothing random is drawn."""
    v0, v1, v2 = verts[tris[:, 0]], verts[tris[:, 1]], verts[tris[:, 2]]
    fn = np.cross(v1 - v0, v2 - v0)
    normals = np.zeros_like(verts)
    for k in range(3):
        np.add.at(normals, tris[:, k], fn)
    nn = np.linalg.norm(normals, axis=1, keepdims=True)
    normals = normals / np.where(nn == 0, 1.0, nn)

    rspec = RenderSpec(n_samples=24, n_surface=8, occupancy=False)
    offset = 0.3
    dev = bound.device
    o_all = torch.from_numpy(verts + normals * offset).to(dev)
    d_all = torch.from_numpy(-normals).to(dev)
    out = []
    for lo in range(0, len(verts), chunk):
        o, d = o_all[lo:lo + chunk], d_all[lo:lo + chunk]
        gt_d = torch.full((o.shape[0],), offset, device=dev)
        out.append(render_rays(params, mspec, grids, bound, o, d, rspec,
                               "color", gt_depth=gt_d)[2])
    col = torch.cat(out).cpu().numpy()
    return (np.clip(col, 0, 1) * 255 + 0.5).astype(np.uint8)


def compose_forecast_occupancy(occ_fine: np.ndarray, occ_coarse: np.ndarray,
                               seen: np.ndarray, hull: np.ndarray):
    """Scene-completion occupancy composition (reference
    Mesher.py:386-418): seen points keep the fine level, unseen points
    inside the scene hull take the coarse (completion) level + 0.2, and
    everything else is forced solid (100, the sign-flipped analogue of
    the reference's -100/100 trick for occupancy polarity) so no
    spurious surface appears outside the mapped volume.

    Returns (composed occupancy, forecast mask)."""
    forecast = (~seen) & hull
    occ = np.where(forecast, occ_coarse + 0.2, occ_fine)
    return np.where(seen | forecast, occ, 100.0), forecast


def _add_time(timings: Optional[dict], key: str, t0: float) -> float:
    t1 = time.perf_counter()
    if timings is not None:
        timings[key] = timings.get(key, 0.0) + (t1 - t0)
    return t1


def extract_mesh(params, mspec: ModelSpec, grids, bound, mc_bound,
                 camera: Camera, spec: MeshSpec,
                 kf_c2w=None, kf_depth=None, n_keyframes: int = 0,
                 out_path: Optional[str] = None,
                 timings: Optional[dict] = None):
    """Extract (and optionally save) the scene mesh of the map on bound's
    device.  kf_c2w (K, 4, 4) and kf_depth (K, H, W) are tensors or arrays
    whose first n_keyframes entries are the keyframes.  With `timings`,
    the host seconds of each part are added to its keys mesh_query,
    mesh_masks, mesh_march, mesh_clean, mesh_color and mesh_write.

    Returns (verts (V,3), tris (T,3), colors (V,3) uint8 or None)."""
    t0 = time.perf_counter()
    dev = bound.device
    mc_bound = np.asarray(mc_bound, np.float64)
    pad = 0.05
    res = spec.resolution
    axes = [np.linspace(mc_bound[a, 0] - pad, mc_bound[a, 1] + pad, res)
            for a in range(3)]
    X, Y, Z = np.meshgrid(*axes, indexing="ij")
    pts = np.stack([X, Y, Z], -1).reshape(-1, 3).astype(np.float32)
    del X, Y, Z
    pts_d = torch.from_numpy(pts).to(dev)

    stage = "fine" if mspec.nice else "color"
    occ = _eval_volume_chunked(params, mspec, grids, bound, pts_d, stage,
                               spec.points_chunk, 3).cpu().numpy()
    t0 = _add_time(timings, "mesh_query", t0)

    n_kf = n_keyframes if kf_c2w is not None else 0
    if n_kf > 0:
        kf_c2w_d = torch.as_tensor(kf_c2w[:n_kf], dtype=torch.float32,
                                   device=dev)
        kf_depth_d = torch.as_tensor(kf_depth[:n_kf], dtype=torch.float32,
                                     device=dev)
        kf_c2w_np = kf_c2w_d.cpu().numpy()
        kf_depth_np = kf_depth_d.cpu().numpy()
        seen = _seen_mask_chunked(pts_d, kf_c2w_d, kf_depth_d, camera,
                                  spec.points_chunk,
                                  spec.depth_test).cpu().numpy()
        if spec.forecast and mspec.nice and mspec.coarse:
            # scene completion: unseen-but-inside-hull points take the
            # coarse level's occupancy + 0.2 (reference Mesher.py:386-418)
            hull_pts = _hull_mask(pts, kf_c2w_np, kf_depth_np, camera,
                                  spec.mesh_bound_scale)
            if hull_pts is None:
                hull_pts = np.zeros(len(pts), bool)
            coarse_occ = _eval_volume_chunked(
                params, mspec, grids, bound, pts_d, "coarse",
                spec.points_chunk, 3).cpu().numpy()
            occ, _ = compose_forecast_occupancy(occ, coarse_occ, seen,
                                                hull_pts)
        else:
            # unseen space is forced solid so no spurious surface appears
            # there; faces there are culled below (reference occ=-100/100
            # trick, Mesher.py:404-433, sign flipped for occupancy)
            occ = np.where(seen, occ, 100.0)
    del pts_d
    t0 = _add_time(timings, "mesh_masks", t0)

    vol = occ.reshape(res, res, res)
    origin = np.array([axes[0][0], axes[1][0], axes[2][0]])
    spacing = np.array([axes[0][1] - axes[0][0], axes[1][1] - axes[1][0],
                        axes[2][1] - axes[2][0]])
    # occupancy: inside = occ > level; marching_tetrahedra uses > iso
    verts, tris = marching_tetrahedra(vol, spec.level_set, origin, spacing)
    t0 = _add_time(timings, "mesh_march", t0)

    vseen = None
    if spec.clean_mesh and len(verts) and n_kf > 0:
        vseen = _seen_mask_chunked(
            torch.from_numpy(verts).to(dev), kf_c2w_d, kf_depth_d, camera,
            spec.points_chunk, spec.depth_test).cpu().numpy()
        hull = _hull_mask(verts, kf_c2w_np, kf_depth_np, camera,
                          spec.mesh_bound_scale)
        if spec.forecast and hull is not None:
            vkeep = hull  # forecast keeps completed regions inside hull
        elif hull is not None:
            vkeep = vseen & hull
        else:
            vkeep = vseen
        fkeep = vkeep[tris].all(axis=1)
        tris = tris[fkeep]
        tris = _component_filter(verts, tris, spec.get_largest_components,
                                 spec.remove_small_geometry_threshold)
        used = np.zeros(len(verts), bool)
        used[tris.reshape(-1)] = True
        remap = np.cumsum(used) - 1
        verts = verts[used]
        vseen = vseen[used]  # keep aligned for the forecast cyan paint
        tris = remap[tris]
    t0 = _add_time(timings, "mesh_clean", t0)

    colors = None
    if spec.color and mspec.nice and len(verts):
        raw_c = _eval_volume_chunked(params, mspec, grids, bound,
                                     torch.from_numpy(verts).to(dev),
                                     "color", spec.points_chunk,
                                     slice(0, 3)).cpu().numpy()
        colors = (np.clip(raw_c, 0, 1) * 255 + 0.5).astype(np.uint8)
        if spec.forecast and vseen is not None:
            # forecast vertices painted cyan (reference Mesher.py:559-565)
            colors[~vseen] = np.array([0, 255, 255], np.uint8)
    elif spec.color and not mspec.nice and len(verts):
        # iMAP*: no colour grid; render a short ray along each vertex
        # normal through the density field (reference Mesher.py:526-553)
        colors = _imap_normal_colors(params, mspec, grids, bound, verts,
                                     tris, spec.points_chunk)
    t0 = _add_time(timings, "mesh_color", t0)

    if out_path is not None and len(verts):
        os.makedirs(os.path.dirname(out_path) or ".", exist_ok=True)
        write_ply(out_path, verts, tris, colors)
    _add_time(timings, "mesh_write", t0)
    return verts, tris, colors


def engine_mesher_hook(engine, idx: int, final: bool):
    """Engine hook: extract and save a mesh as the reference mapper does
    (Mapper.py:636-654): <output>/mesh/{idx:05d}_mesh.ply, or
    final_mesh.ply at the last frame.  The host seconds of each part are
    added to engine.timings."""
    m = engine.cfg["meshing"]
    spec = MeshSpec(
        resolution=m["resolution"],
        level_set=m["level_set"],
        forecast=m.get("mesh_coarse_level", False),
        clean_mesh=m["clean_mesh"],
        depth_test=m["depth_test"],
        get_largest_components=m["get_largest_components"],
        remove_small_geometry_threshold=m["remove_small_geometry_threshold"],
        mesh_bound_scale=m["clean_mesh_bound_scale"],
    )
    name = "final_mesh.ply" if final else f"{idx:05d}_mesh.ply"
    st = engine.map_state
    mc_bound = engine.cfg["mapping"]["marching_cubes_bound"]
    extract_mesh(
        st.params, engine.specs.model, st.grids, engine.bound, mc_bound,
        engine.specs.camera, spec,
        kf_c2w=engine.store.est_c2w, kf_depth=engine.store.depths,
        n_keyframes=int(engine.store.count),
        out_path=os.path.join(engine.output, "mesh", name),
        timings=engine.timings)
    if final and m.get("eval_rec"):
        # evaluation mesh: visibility from ALL tracked frames (reference
        # Mapper.py:649-653, get_mask_use_all_frames=True).  Only keyframes
        # keep their depth, so the all-frames mask is frustum-only
        # (depth_test off) and the depths are 1x1 placeholders.
        traj, _, tracked = engine.map_side()
        n = max(tracked, idx + 1)
        extract_mesh(
            st.params, engine.specs.model, st.grids, engine.bound, mc_bound,
            engine.specs.camera, dc_replace(spec, depth_test=False),
            kf_c2w=traj[:n].detach().cpu().numpy(),
            kf_depth=np.zeros((n, 1, 1), np.float32), n_keyframes=n,
            out_path=os.path.join(engine.output, "mesh",
                                  "final_mesh_eval_rec.ply"),
            timings=engine.timings)
