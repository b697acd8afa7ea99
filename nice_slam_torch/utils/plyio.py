"""Minimal PLY mesh I/O (binary little-endian + ascii read/write).

First-party replacement for the reference's trimesh export path
(Mesher.py:570-572) — trimesh is not a dependency of this framework.
"""

from __future__ import annotations

import struct
from typing import Optional, Tuple

import numpy as np


def write_ply(path: str, verts: np.ndarray, tris: np.ndarray,
              colors: Optional[np.ndarray] = None) -> None:
    """verts (V,3) f32; tris (T,3) int; colors (V,3) float [0,1] or uint8."""
    verts = np.asarray(verts, np.float32)
    tris = np.asarray(tris, np.int32)
    has_color = colors is not None
    if has_color:
        colors = np.asarray(colors)
        if colors.dtype != np.uint8:
            colors = np.clip(colors * 255.0 + 0.5, 0, 255).astype(np.uint8)

    with open(path, "wb") as f:
        hdr = ["ply", "format binary_little_endian 1.0",
               f"element vertex {len(verts)}",
               "property float x", "property float y", "property float z"]
        if has_color:
            hdr += ["property uchar red", "property uchar green",
                    "property uchar blue"]
        hdr += [f"element face {len(tris)}",
                "property list uchar int vertex_indices", "end_header"]
        f.write(("\n".join(hdr) + "\n").encode())

        if has_color:
            rec = np.zeros(len(verts),
                           dtype=[("xyz", np.float32, 3),
                                  ("rgb", np.uint8, 3)])
            rec["xyz"] = verts
            rec["rgb"] = colors
            f.write(rec.tobytes())
        else:
            f.write(verts.astype("<f4").tobytes())

        face = np.zeros(len(tris),
                        dtype=[("n", np.uint8), ("idx", "<i4", 3)])
        face["n"] = 3
        face["idx"] = tris
        f.write(face.tobytes())


def read_ply(path: str) -> Tuple[np.ndarray, np.ndarray, Optional[np.ndarray]]:
    """Reads the subset of PLY written by write_ply (+ ascii variants).
    Returns (verts, tris, colors_or_None)."""
    with open(path, "rb") as f:
        data = f.read()
    head_end = data.find(b"end_header\n")
    header = data[:head_end].decode().splitlines()
    body = data[head_end + len(b"end_header\n"):]

    fmt = "binary_little_endian"
    n_vert = n_face = 0
    vert_props = []
    cur = None
    for line in header:
        parts = line.split()
        if not parts:
            continue
        if parts[0] == "format":
            fmt = parts[1]
        elif parts[0] == "element":
            cur = parts[1]
            if cur == "vertex":
                n_vert = int(parts[2])
            elif cur == "face":
                n_face = int(parts[2])
        elif parts[0] == "property" and cur == "vertex" \
                and parts[1] != "list":
            vert_props.append((parts[2], parts[1]))

    type_map = {"float": "<f4", "float32": "<f4", "double": "<f8",
                "uchar": "u1", "uint8": "u1", "int": "<i4", "uint": "<u4"}
    names = [p[0] for p in vert_props]

    if fmt == "ascii":
        rows = body.decode().splitlines()
        vert_rows = [r.split() for r in rows[:n_vert]]
        arr = np.array([[float(v) for v in r[:len(names)]]
                        for r in vert_rows])
        verts = arr[:, [names.index("x"), names.index("y"),
                        names.index("z")]].astype(np.float32)
        colors = None
        if "red" in names:
            colors = arr[:, [names.index("red"), names.index("green"),
                             names.index("blue")]].astype(np.uint8)
        tris = np.array([[int(v) for v in r.split()[1:4]]
                         for r in rows[n_vert:n_vert + n_face]], np.int64)
        return verts, tris, colors

    dt = np.dtype([(n, type_map[t]) for n, t in vert_props])
    vbytes = n_vert * dt.itemsize
    varr = np.frombuffer(body[:vbytes], dtype=dt, count=n_vert)
    verts = np.stack([varr["x"], varr["y"], varr["z"]], -1).astype(np.float32)
    colors = None
    if "red" in varr.dtype.names:
        colors = np.stack([varr["red"], varr["green"], varr["blue"]],
                          -1).astype(np.uint8)
    fdt = np.dtype([("n", "u1"), ("idx", "<i4", 3)])
    farr = np.frombuffer(body[vbytes:vbytes + n_face * fdt.itemsize],
                         dtype=fdt, count=n_face)
    tris = farr["idx"].astype(np.int64)
    return verts, tris, colors
