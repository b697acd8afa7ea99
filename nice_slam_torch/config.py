"""Config loading for the PyTorch port: YAML with recursive `inherit_from`
merging over in-code defaults, plus typed spec construction.

Resolves exactly the same dict as the JAX package's loader for every file
under configs/ (the tests hold the two against each other), so one scene
yaml drives both engines.  The `tpu` section is kept verbatim for that
reason; the port reads only its `seed` and ignores the dispatch knobs.
"""

from __future__ import annotations

import copy
import os
from dataclasses import dataclass, replace
from typing import Any, Dict, Optional

import yaml

from nice_slam_torch.camera import Camera
from nice_slam_torch.mapping import MapSpec, StageLR
from nice_slam_torch.models.decoders import ModelSpec
from nice_slam_torch.render import RenderSpec
from nice_slam_torch.tracking import TrackSpec

# Root defaults.  Values mirror the reference's base config
# (configs/nice_slam.yaml) so behavior matches.
DEFAULTS: Dict[str, Any] = {
    "nice": True,
    "coarse": True,
    "sync_method": "strict",
    "scale": 1.0,
    "verbose": False,
    "occupancy": True,
    "dataset": "synthetic",
    "grid_len": {
        "coarse": 2.0,
        "middle": 0.32,
        "fine": 0.16,
        "color": 0.16,
        "bound_divisible": 0.32,
    },
    "pretrained_decoders": {
        "coarse": "pretrained/coarse.pt",          # reference-format torch
        "middle_fine": "pretrained/middle_fine.pt",
        "tpu_npz": "pretrained/decoders_tpu.npz",  # this repo's own
    },
    "meshing": {
        "level_set": 0.0,
        "resolution": 256,
        "eval_rec": False,
        "clean_mesh": True,
        "depth_test": False,
        "mesh_coarse_level": False,
        "clean_mesh_bound_scale": 1.02,
        "get_largest_components": False,
        "color_mesh_extraction_method": "direct_point_query",
        "remove_small_geometry_threshold": 0.2,
        "mesh_bound_scale": 1.02,
    },
    "tracking": {
        "ignore_edge_W": 20,
        "ignore_edge_H": 20,
        "use_color_in_tracking": True,
        "handle_dynamic": True,
        "vis_freq": 50,
        "vis_inside_freq": 25,
        "w_color_loss": 0.5,
        "seperate_LR": False,
        "const_speed_assumption": True,
        "init_select": True,
        "init_select_margin": 3.0,
        # Gauss-Newton pose polish (parallel/schur_ba.py), off by default
        "pose_GN_iters": 0,
        "pose_GN_pixels": 1000,
        "pose_GN_damping": 1.0e-3,
        "no_vis_on_first_frame": True,
        "gt_camera": False,
        "lr": 0.001,
        "pixels": 200,
        "iters": 10,
    },
    "mapping": {
        "every_frame": 5,
        "color_refine": True,
        "middle_iter_ratio": 0.4,
        "fine_iter_ratio": 0.6,
        "BA": True,
        "BA_cam_lr": 0.001,
        "fix_fine": True,
        "fix_color": False,
        "train_middle_decoder": False,
        "grad_clip": 0.0,
        "no_vis_on_first_frame": True,
        "no_mesh_on_first_frame": True,
        "no_log_on_first_frame": True,
        "vis_freq": 50,
        "vis_inside_freq": 25,
        "mesh_freq": 50,
        "ckpt_freq": 500,
        "keyframe_every": 50,
        "mapping_window_size": 5,
        "w_color_loss": 0.2,
        "frustum_feature_selection": True,
        "keyframe_selection_method": "overlap",
        "save_selected_keyframes_info": False,
        "lr_first_factor": 5.0,
        "lr_factor": 1.0,
        "pixels": 1000,
        "iters_first": 1500,
        "iters": 60,
        "imap_decoders_lr": 0.0002,
        "bound": [[-4.0, 4.0], [-4.0, 4.0], [-4.0, 4.0]],
        "marching_cubes_bound": None,  # defaults to bound
        "stage": {
            "coarse": {"decoders_lr": 0.0, "coarse_lr": 0.001,
                       "middle_lr": 0.0, "fine_lr": 0.0, "color_lr": 0.0},
            "middle": {"decoders_lr": 0.0, "coarse_lr": 0.0,
                       "middle_lr": 0.1, "fine_lr": 0.0, "color_lr": 0.0},
            "fine": {"decoders_lr": 0.0, "coarse_lr": 0.0,
                     "middle_lr": 0.005, "fine_lr": 0.005, "color_lr": 0.0},
            "color": {"decoders_lr": 0.005, "coarse_lr": 0.0,
                      "middle_lr": 0.005, "fine_lr": 0.005,
                      "color_lr": 0.005},
        },
    },
    "cam": {
        "H": 680, "W": 1200, "fx": 600.0, "fy": 600.0,
        "cx": 599.5, "cy": 339.5,
        "png_depth_scale": 6553.5,
        "crop_edge": 0,
        "crop_size": None,
        "distortion": None,
    },
    "rendering": {
        "N_samples": 32,
        "N_surface": 16,
        "N_importance": 0,
        "lindisp": False,
        "perturb": 0.0,
        # occupancy-guided sampling (ops/sampling.occ_guided_zvals), off
        # by default: the JAX package measured it as worse than uniform
        "occupancy_guided": False,
    },
    "data": {"dim": 3, "input_folder": None, "output": "output/run"},
    "model": {
        "c_dim": 32,
        "coarse_bound_enlarge": 2,
        "pos_embedding_method": "fourier",
        "hidden_size": 32,
    },
    # the JAX package's runtime section, kept verbatim so both loaders
    # resolve the same dict; the port reads `seed` and `keyframe_capacity`
    # and ignores the dispatch knobs
    "tpu": {
        "seed": 0,
        "precision": "float32",
        "matmul_precision": "default",
        "grouped_tracking": True,
        "pipelined": False,
        "data_parallel": False,
        "mesh_shape": None,
        "keyframe_capacity": None,
        "render_chunk": 16384,
        "fuse_lagged": None,
        "barrier_every_groups": 4,
    },
}

# iMAP* base overrides (reference configs/imap.yaml)
IMAP_OVERRIDES: Dict[str, Any] = {
    "nice": False,
    "coarse": False,
    "scale": 0.1,
    "occupancy": False,
    "meshing": {"level_set": 10.0,
                "color_mesh_extraction_method": "render_ray_along_normal"},
    "tracking": {"handle_dynamic": False, "pixels": 5000, "iters": 50},
    "mapping": {
        "BA": False,
        "BA_cam_lr": 0.0002,
        "frustum_feature_selection": False,
        "keyframe_selection_method": "global",
        "w_color_loss": 0.05,
        "pixels": 5000,
        "iters": 300,
    },
    "rendering": {"N_samples": 32, "N_surface": 0, "N_importance": 12},
}


def update_recursive(dst: dict, src: dict) -> None:
    for k, v in src.items():
        if isinstance(v, dict):
            if not isinstance(dst.get(k), dict):
                dst[k] = {}
            update_recursive(dst[k], v)
        else:
            dst[k] = v


def load_config(path: Optional[str] = None, nice: bool = True,
                overrides: Optional[dict] = None) -> dict:
    """Load a scene config: DEFAULTS (+imap overrides) <- inherit_from
    chain <- the file itself <- overrides."""
    cfg = copy.deepcopy(DEFAULTS)
    if not nice:
        update_recursive(cfg, copy.deepcopy(IMAP_OVERRIDES))
        cfg["nice"] = False

    def load_chain(p: str) -> dict:
        with open(p) as f:
            special = yaml.safe_load(f) or {}
        parent = special.pop("inherit_from", None)
        merged = {}
        if parent is not None:
            if not os.path.isabs(parent) and not os.path.exists(parent):
                cand = os.path.join(os.path.dirname(os.path.dirname(p)),
                                    os.path.basename(os.path.dirname(parent)),
                                    os.path.basename(parent))
                parent = parent if os.path.exists(parent) else cand
            merged = load_chain(parent)
        update_recursive(merged, special)
        return merged

    if path is not None:
        update_recursive(cfg, load_chain(path))
    if overrides:
        update_recursive(cfg, overrides)
    if cfg["mapping"].get("marching_cubes_bound") is None:
        cfg["mapping"]["marching_cubes_bound"] = cfg["mapping"]["bound"]
    return cfg


# ---------------------------------------------------------------------------
# Typed spec assembly


@dataclass(frozen=True)
class SlamSpecs:
    camera: Camera
    model: ModelSpec
    render: RenderSpec
    track: TrackSpec
    mapper: MapSpec
    coarse_mapper: Optional[MapSpec]


def specs_from_config(cfg: dict) -> SlamSpecs:
    nice = bool(cfg["nice"])
    camera = Camera.from_cfg(cfg["cam"])
    model = ModelSpec(
        nice=nice,
        coarse=bool(cfg["coarse"]),
        c_dim=cfg["model"]["c_dim"],
        hidden=cfg["model"].get("hidden_size", 32),
        pos_embedding_method=cfg["model"]["pos_embedding_method"],
        coarse_bound_enlarge=cfg["model"]["coarse_bound_enlarge"],
    )
    r = cfg["rendering"]
    render = RenderSpec(
        n_samples=r["N_samples"], n_surface=r["N_surface"],
        n_importance=r["N_importance"], lindisp=r["lindisp"],
        perturb=r["perturb"], occupancy=bool(cfg["occupancy"]),
        occ_guided=bool(r.get("occupancy_guided", False)),
    )
    t = cfg["tracking"]
    track = TrackSpec(
        iters=t["iters"], pixels=t["pixels"], lr=t["lr"],
        seperate_lr=t["seperate_LR"], w_color_loss=t["w_color_loss"],
        ignore_edge_w=t["ignore_edge_W"], ignore_edge_h=t["ignore_edge_H"],
        handle_dynamic=t["handle_dynamic"],
        use_color=t["use_color_in_tracking"],
        const_speed=t["const_speed_assumption"],
        init_select=t["init_select"],
        init_select_margin=t["init_select_margin"],
        gn_iters=t.get("pose_GN_iters", 0),
        gn_pixels=t.get("pose_GN_pixels", 1000),
        gn_damping=t.get("pose_GN_damping", 1e-3), nice=nice,
    )
    m = cfg["mapping"]
    stage_lr = tuple(sorted(
        (name, StageLR(
            decoders=s["decoders_lr"], coarse=s["coarse_lr"],
            middle=s["middle_lr"], fine=s["fine_lr"], color=s["color_lr"]))
        for name, s in m["stage"].items()))
    mapper = MapSpec(
        pixels=m["pixels"], window_size=m["mapping_window_size"],
        w_color_loss=m["w_color_loss"],
        middle_iter_ratio=m["middle_iter_ratio"],
        fine_iter_ratio=m["fine_iter_ratio"],
        fix_fine=m["fix_fine"], fix_color=m["fix_color"],
        train_middle=m.get("train_middle_decoder", False),
        grad_clip=m.get("grad_clip", 0.0),
        frustum_selection=m["frustum_feature_selection"],
        keyframe_selection=m["keyframe_selection_method"],
        keyframe_every=m["keyframe_every"],
        ba=m["BA"], ba_cam_lr=m["BA_cam_lr"], nice=nice,
        coarse_mapper=False, imap_decoders_lr=m["imap_decoders_lr"],
        pose_gn_iters=m.get("pose_GN_iters", 0),
        pose_gn_pixels=m.get("pose_GN_pixels", 200),
        pose_gn_damping=m.get("pose_GN_damping", 1e-3),
        stage_lr=stage_lr,
    )
    coarse_mapper = None
    if nice and cfg["coarse"]:
        # coarse mapper: global selection, no BA, coarse stage only
        # (reference Mapper.py:78-80, 403-404, 602-603)
        coarse_mapper = replace(mapper, coarse_mapper=True,
                                keyframe_selection="global", ba=False,
                                pose_gn_iters=0)
    return SlamSpecs(camera=camera, model=model, render=render, track=track,
                     mapper=mapper, coarse_mapper=coarse_mapper)
