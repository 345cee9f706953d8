"""Headless visualization — the analog of the reference GUI's overlays.

The reference paints domain contours, inside points, and a live preview of
the warped domain onto the und/def image labels (imageLabel.cpp:708-960
applyModel{Rectangular,Annular,Blob}; overlay painting via the
send_*_points signals, manager_class.cpp:488-516).  Headless equivalents:

  * sector_outlines(...)   — per-sector domain outline polylines
  * preview_warp(...)      — the applyModel* analog: warp an outline under
                             the current parameters about the domain center
  * render_overlay(...)    — draw polylines/points onto a frame (PIL)
  * save_sequence_overlays — one annotated PNG per frame pair
"""

from __future__ import annotations

import math
import os

import numpy as np

from correlation_jax.config import FittingModel
from correlation_jax.models.warp import warp_points


def rect_outline(x0: float, y0: float, x1: float, y1: float,
                 points_per_edge: int = 16) -> np.ndarray:
    """Closed rectangle outline as a dense polyline [N, 2].

    Dense (not just 4 corners) so that non-rigid warps curve the edges in
    previews, like the reference's per-edge sampling
    (imageLabel.cpp:708-814).
    """
    t = np.linspace(0.0, 1.0, points_per_edge, endpoint=False)
    top = np.stack([x0 + (x1 - x0) * t, np.full_like(t, y0)], -1)
    right = np.stack([np.full_like(t, x1), y0 + (y1 - y0) * t], -1)
    bottom = np.stack([x1 - (x1 - x0) * t, np.full_like(t, y1)], -1)
    left = np.stack([np.full_like(t, x0), y1 - (y1 - y0) * t], -1)
    out = np.concatenate([top, right, bottom, left, top[:1]], 0)
    return out.astype(np.float32)


def annular_sector_outline(
    cx: float,
    cy: float,
    r_in: float,
    r_out: float,
    a0: float,
    a1: float,
    points_per_arc: int = 24,
) -> np.ndarray:
    """Outline polyline of one annular sector (imageLabel.cpp:816-887)."""
    ang = np.linspace(a0, a1, points_per_arc)
    inner = np.stack([cx + r_in * np.cos(ang), cy + r_in * np.sin(ang)], -1)
    outer = np.stack(
        [cx + r_out * np.cos(ang[::-1]), cy + r_out * np.sin(ang[::-1])], -1
    )
    out = np.concatenate([inner, outer, inner[:1]], 0)
    return out.astype(np.float32)


def annulus_outlines(cx, cy, r_in, r_out, radial_subdivisions=1,
                     angular_subdivisions=1) -> list[np.ndarray]:
    """Per-sector outlines of a subdivided annulus
    (manager_class.cpp:557-617 sector tiling)."""
    outs = []
    dr = (r_out - r_in) / radial_subdivisions
    da = 2.0 * math.pi / angular_subdivisions
    for ri in range(radial_subdivisions):
        for ai in range(angular_subdivisions):
            outs.append(
                annular_sector_outline(
                    cx, cy, r_in + ri * dr, r_in + (ri + 1) * dr,
                    ai * da, (ai + 1) * da,
                )
            )
    return outs


def preview_warp(
    model: FittingModel,
    params: np.ndarray,
    outline: np.ndarray,
    center: np.ndarray,
) -> np.ndarray:
    """Warp an outline polyline under the current parameters.

    The analog of the GUI's live initial-guess preview: the reference warps
    the domain outline about the domain center with the model's distortion
    functions (imageLabel.cpp:708-814, interpolation_class.cpp:3-43).
    """
    import jax.numpy as jnp

    out = warp_points(
        model,
        jnp.asarray(np.asarray(params, np.float32)),
        jnp.asarray(np.asarray(outline, np.float32)),
        jnp.asarray(np.asarray(center, np.float32)),
    )
    return np.asarray(out)


def _to_rgb(frame: np.ndarray) -> np.ndarray:
    img = np.asarray(frame)
    if img.ndim == 3 and img.shape[-1] == 1:
        img = img[..., 0]
    img = np.clip(img, 0, 255).astype(np.uint8)
    if img.ndim == 2:
        img = np.stack([img] * 3, -1)
    return img


def render_overlay(
    frame: np.ndarray,
    polylines: list[np.ndarray] | None = None,
    points: np.ndarray | None = None,
    line_color=(0, 255, 0),
    point_color=(255, 64, 64),
    dots: np.ndarray | None = None,
    dot_color=(64, 128, 255),
):
    """Draw polylines and point markers onto a frame.

    Args:
      frame: [H, W] or [H, W, C] uint8-valued image.
      polylines: list of [N, 2] (x, y) polylines.
      points: [M, 2] (x, y) marker positions (crosses).
      dots: [M, 2] (x, y) single-pixel markers — dense sets like warped
        subset pixels (the plot_inside_points analog,
        manager_class.cpp:606-612); written directly into the bitmap so
        tens of thousands draw fast.

    Returns:
      A PIL.Image in RGB.
    """
    from PIL import Image, ImageDraw

    rgb = _to_rgb(frame).copy()
    if dots is not None and len(dots):
        d = np.floor(np.asarray(dots, np.float64) + 0.5).astype(np.int64)
        h, w = rgb.shape[:2]
        keep = (
            (d[:, 0] >= 0) & (d[:, 0] < w) & (d[:, 1] >= 0) & (d[:, 1] < h)
        )
        d = d[keep]
        rgb[d[:, 1], d[:, 0]] = np.asarray(dot_color, np.uint8)
    img = Image.fromarray(rgb)
    draw = ImageDraw.Draw(img)
    for line in polylines or []:
        pts = [(float(x), float(y)) for x, y in np.asarray(line)]
        if len(pts) >= 2:
            draw.line(pts, fill=line_color, width=1)
    if points is not None:
        for x, y in np.asarray(points):
            x, y = float(x), float(y)
            draw.line([(x - 2, y), (x + 2, y)], fill=point_color, width=1)
            draw.line([(x, y - 2), (x, y + 2)], fill=point_color, width=1)
    return img


def save_sequence_overlays(
    frames,
    records,
    out_dir: str,
    prefix: str = "overlay",
    point_lists: list[np.ndarray] | None = None,
    model=None,
) -> list[str]:
    """Write one annotated PNG per frame pair.

    Each image is the DEFORMED frame of the pair with the tracked deformed
    contours (if contour tracking was on) and the deformed sector centers —
    the headless equivalent of the live def-image overlay.  Also writes
    `<prefix>_und.png`: frame 0 with the undeformed contours/centers.

    point_lists + model: when given, each overlay also shows the WARPED
    subset pixels (sequence.warped_inside_points — the getDefXY0ToCPU /
    plot_inside_points analog, cuda_polygon.cu:49-90,
    manager_class.cpp:606-612).  Under the (default) Eulerian description
    the undeformed points are stationary, so the frame-0 lists apply to
    every pair; a record carrying its own und_points (Lagrangian runs
    with SequenceConfig.record_points) overrides them — the domain
    follows the material, so each frame warps THAT frame's point lists.
    """
    os.makedirs(out_dir, exist_ok=True)
    written = []
    if records:
        rec0 = records[0]
        path = os.path.join(out_dir, f"{prefix}_und.png")
        lists0 = rec0.und_points if rec0.und_points is not None else point_lists
        und_dots = (
            np.concatenate(lists0, axis=0) if lists0 is not None else None
        )
        render_overlay(
            frames[0], rec0.und_contours, rec0.und_center, dots=und_dots
        ).save(path)
        written.append(path)
    for rec in records:
        img = frames[rec.frame + 1]
        path = os.path.join(out_dir, f"{prefix}_{rec.frame + 1:05d}.png")
        dots = None
        lists = rec.und_points if rec.und_points is not None else point_lists
        if lists is not None and model is not None:
            from correlation_jax.sequence import warped_inside_points

            warped = warped_inside_points(
                model, rec.params, lists, rec.und_center
            )
            dots = np.concatenate(warped, axis=0)
        render_overlay(
            img, rec.def_contours, rec.def_center, dots=dots
        ).save(path)
        written.append(path)
    return written
