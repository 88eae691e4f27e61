"""Offline trajectory refinement through the window-sharded BA layer.

The production role of rso.ba.window_sharded (BASELINE.md round-4 section):
a long VO trajectory is split into overlapping keyframe windows, EVERY
window solves concurrently over the ('win','lmk') mesh (hosts x chips, zero
steady-state DCN traffic), and the solved windows stitch back into one
global trajectory.  This tool runs that pipeline end-to-end on a long
textured corridor and reports ATE: plain VO vs window-sharded refinement.

Usage (virtual 8-device mesh, CPU):
  XLA_FLAGS=--xla_force_host_platform_device_count=8 JAX_PLATFORMS=cpu \
  python tools/eval_global_refine.py [--frames 240]

Writes docs/artifacts/global_refine_r4.json.
"""
import argparse
import json
import os
import sys

import numpy as np

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--frames", type=int, default=240)
    ap.add_argument("--speed", type=float, default=0.5)
    ap.add_argument("--width", type=int, default=320)
    ap.add_argument("--height", type=int, default=200)
    ap.add_argument("--kf-gap", type=int, default=3)
    ap.add_argument("--window", type=int, default=8)
    ap.add_argument("--overlap", type=int, default=2)
    ap.add_argument("--seeds", type=int, nargs="+", default=[0, 1, 2])
    ap.add_argument("--out", default=os.path.join(
        ROOT, "docs", "artifacts", "global_refine_r5.json"))
    args = ap.parse_args()

    import jax

    from rso.ba.offline import KeyframeCollector, refine_trajectory
    from rso.ba.window_sharded import make_win_mesh
    from rso.engine import Engine
    from rso.geometry import pose_matrix
    from rso.metrics.ate import ate_rmse
    from rso.synthetic import make_textured_sequence, textured_config

    n_dev = len(jax.devices())
    n_win_axis = min(4, n_dev)
    mesh = make_win_mesh(n_win_axis, max(n_dev // n_win_axis, 1))
    print(f"devices: {n_dev}, mesh {mesh.devices.shape} ('win','lmk')",
          flush=True)

    results = []
    for seed in args.seeds:
        cam = None
        if args.width > 320:   # KITTI-class geometry at full resolution
            from rso.geometry.stereo_camera import StereoCamera

            cam = StereoCamera.make(fx_l=718.856, fy_l=718.856,
                                    cx_l=args.width / 2.0,
                                    cy_l=args.height / 2.0, baseline=0.5371)
        seq = make_textured_sequence(n_frames=args.frames, H=args.height,
                                     W=args.width, speed=args.speed,
                                     seed=seed, cam=cam,
                                     px_per_m=24.0 if args.width > 320
                                     else 48.0,
                                     corridor=(8.0, 3.0) if args.width > 320
                                     else (4.0, 2.0))
        cfg = textured_config()
        eng = Engine(cfg, seq.cam)

        # ---- VO pass, collecting keyframe observations -------------------
        coll = KeyframeCollector(eng, cfg, min_kf_gap=args.kf_gap)
        T = np.eye(4)
        vo_poses = []
        for i, (l, r) in enumerate(seq.frames):
            res = eng.process_frame(l, r)
            if bool(res.valid):
                T = T @ np.asarray(pose_matrix(res.pose))
            vo_poses.append(T.copy())
            coll.observe(i, res, T)
        vo_poses = np.stack(vo_poses)
        ate_vo = float(ate_rmse(vo_poses, seq.poses))
        n_kf = len(coll.kfs)
        print(f"seed {seed}: {n_kf} keyframes from {args.frames} frames, "
              f"VO ATE {ate_vo:.4f}", flush=True)

        # ---- one sharded solve for ALL windows + stitch ------------------
        import time as _time

        _t0 = _time.perf_counter()
        refined = refine_trajectory(
            seq.cam, coll.kfs, coll.kf_frame_idx, vo_poses,
            window=args.window, overlap=args.overlap, mesh=mesh)
        solve_wall_s = _time.perf_counter() - _t0
        ate_ref = float(ate_rmse(refined, seq.poses))
        n_windows = max(1, -(-(n_kf - args.overlap)
                             // (args.window - args.overlap)))
        print(f"seed {seed}: refined ATE {ate_ref:.4f} "
              f"({ate_vo / max(ate_ref, 1e-9):.2f}x)", flush=True)
        results.append({
            "seed": seed, "frames": args.frames, "keyframes": n_kf,
            "windows": n_windows, "ate_vo_m": round(ate_vo, 4),
            "ate_refined_m": round(ate_ref, 4),
            "improvement": round(ate_vo / max(ate_ref, 1e-9), 3),
            "solve_wall_s": round(solve_wall_s, 2),
        })

    doc = {
        "what": "offline window-sharded global refinement (rso.ba."
                "window_sharded): VO -> overlapping windows -> one sharded "
                "solve over ('win','lmk') mesh -> stitch",
        "mesh": list(mesh.devices.shape),
        "mean_improvement": round(
            float(np.mean([r["improvement"] for r in results])), 3),
        "results": results,
    }
    os.makedirs(os.path.dirname(args.out), exist_ok=True)
    with open(args.out, "w") as f:
        json.dump(doc, f, indent=1)
    print(json.dumps(doc["results"]))
    print(f"wrote {args.out}")
    return 0


if __name__ == "__main__":
    sys.exit(main())
