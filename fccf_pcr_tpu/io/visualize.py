"""Headless visualization exports.

Equivalent of the reference's PCLVisualizer debug views (``showPic`` /
``showPointPic``, FCCF.cpp:257-323, C5 — never called from the CLI path):
instead of opening VTK windows (impossible on a headless accelerator host), these
helpers export colored PLY files viewable in any point-cloud tool
(CloudCompare, MeshLab): one color per face, centroid markers, and
before/after registration overlays.
"""

from __future__ import annotations

import numpy as np


def _write_colored_ply(path, points, colors):
    points = np.asarray(points, np.float32)
    colors = np.asarray(colors, np.uint8)
    n = len(points)
    header = (
        "ply\nformat binary_little_endian 1.0\n"
        f"element vertex {n}\n"
        "property float x\nproperty float y\nproperty float z\n"
        "property uchar red\nproperty uchar green\nproperty uchar blue\n"
        "end_header\n"
    )
    rec = np.zeros(
        n,
        dtype=[("x", "<f4"), ("y", "<f4"), ("z", "<f4"),
               ("r", "u1"), ("g", "u1"), ("b", "u1")],
    )
    rec["x"], rec["y"], rec["z"] = points[:, 0], points[:, 1], points[:, 2]
    rec["r"], rec["g"], rec["b"] = colors[:, 0], colors[:, 1], colors[:, 2]
    with open(path, "wb") as f:
        f.write(header.encode("ascii"))
        f.write(rec.tobytes())


def _palette(n, seed=0):
    rng = np.random.default_rng(seed)
    return rng.integers(40, 255, (n, 3)).astype(np.uint8)


def export_faces(path, points, point_face, n_faces=None, seed=0):
    """Color every point by its face id (== showPic's per-face random
    colors). ``point_face`` < 0 marks unassigned points (dark gray).
    ``n_faces`` defaults to covering every id present — an explicit
    smaller value would silently paint ids >= n_faces as unassigned."""
    points = np.asarray(points)
    point_face = np.asarray(point_face)
    if n_faces is None:
        n_faces = max(int(point_face.max(initial=-1)) + 1, 1)
    pal = _palette(n_faces, seed)
    colors = np.full((len(points), 3), 60, np.uint8)
    ok = (point_face >= 0) & (point_face < n_faces)
    colors[ok] = pal[point_face[ok]]
    _write_colored_ply(path, points, colors)


def export_registration(path, src_points, tar_points, T):
    """Before/after overlay: target gray, transformed source red — the
    qualitative render of README.md's office_result figure."""
    src = np.asarray(src_points, np.float32)
    tar = np.asarray(tar_points, np.float32)
    T = np.asarray(T)
    src_t = src @ T[:3, :3].T + T[:3, 3]
    pts = np.concatenate([tar, src_t])
    colors = np.concatenate(
        [
            np.tile(np.array([180, 180, 180], np.uint8), (len(tar), 1)),
            np.tile(np.array([230, 60, 60], np.uint8), (len(src_t), 1)),
        ]
    )
    _write_colored_ply(path, pts, colors)
