"""Offline visualization writer — rso's GUI replacement.

The reference runs a live MRPT 3-viewport window on a second thread
(gui_thread.cpp:76-325: left/right images with feature marks, L/R pairing
rectangles, tracking lines, integrated 3D path).  Here the same overlays are
written as PNG frames / an HTML trajectory view from host callbacks outside
the hot path — nothing blocks the device.
"""
from __future__ import annotations

import os

import numpy as np


def draw_overlay(left_img: np.ndarray, right_img: np.ndarray,
                 kp_left=None, kp_right=None, pairings=None, tracks=None):
    """Compose a side-by-side BGR overlay frame (needs cv2)."""
    import cv2

    H, W = left_img.shape[:2]
    canvas = np.zeros((H, 2 * W, 3), np.uint8)
    canvas[:, :W] = cv2.cvtColor(left_img, cv2.COLOR_GRAY2BGR)
    canvas[:, W:] = cv2.cvtColor(right_img, cv2.COLOR_GRAY2BGR)

    if kp_left is not None:  # red feature marks (reference stage2 draw)
        for x, y in np.asarray(kp_left):
            cv2.circle(canvas, (int(x), int(y)), 2, (0, 0, 255), -1)
    if kp_right is not None:
        for x, y in np.asarray(kp_right):
            cv2.circle(canvas, (int(x) + W, int(y)), 2, (0, 0, 255), -1)
    if pairings is not None:  # green L-R pairing lines (draw_lr_pairings)
        for (xl, yl), (xr, yr) in pairings:
            cv2.line(canvas, (int(xl), int(yl)), (int(xr) + W, int(yr)),
                     (0, 255, 0), 1)
    if tracks is not None:  # blue prev->cur tracking lines (draw_tracking)
        for (x0, y0), (x1, y1) in tracks:
            cv2.line(canvas, (int(x0), int(y0)), (int(x1), int(y1)),
                     (255, 128, 0), 1)
    return canvas


class VizWriter:
    def __init__(self, out_dir: str, every: int = 1):
        self.out_dir = out_dir
        self.every = every
        os.makedirs(out_dir, exist_ok=True)

    def write_frame(self, frame_idx: int, canvas: np.ndarray):
        if frame_idx % self.every:
            return
        import cv2

        cv2.imwrite(os.path.join(self.out_dir, f"viz_{frame_idx:04d}.png"),
                    canvas)

    def write_trajectory_html(self, poses: np.ndarray,
                              gt_poses: np.ndarray | None = None,
                              name: str = "trajectory.html"):
        """Self-contained SVG top-down (x,z) trajectory plot."""
        est = np.asarray(poses)[:, [0, 2], 3]
        pts = [est] + ([np.asarray(gt_poses)[:, [0, 2], 3]]
                       if gt_poses is not None else [])
        allp = np.concatenate(pts)
        lo = allp.min(0) - 1
        hi = allp.max(0) + 1
        span = np.maximum(hi - lo, 1e-6)
        S = 600

        def path(p, color):
            coords = " ".join(
                f"{(x - lo[0]) / span[0] * S:.1f},{S - (z - lo[1]) / span[1] * S:.1f}"
                for x, z in p)
            return (f'<polyline points="{coords}" fill="none" '
                    f'stroke="{color}" stroke-width="2"/>')

        svg = [f'<svg xmlns="http://www.w3.org/2000/svg" width="{S}" height="{S}" '
               f'style="background:#fff">']
        svg.append(path(est, "#1668a8"))
        if gt_poses is not None:
            svg.append(path(pts[1], "#999999"))
        svg.append("</svg>")
        html = ("<html><body><h3>rso trajectory (blue=estimate"
                + (", gray=ground truth" if gt_poses is not None else "")
                + ")</h3>" + "".join(svg) + "</body></html>")
        with open(os.path.join(self.out_dir, name), "w") as f:
            f.write(html)
