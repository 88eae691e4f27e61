"""Drive the FULL real-data path on real photographs: KITTI-layout tree ->
C++ decode ring -> rso-demo CLI -> trajectory -> consistency eval.

KITTI/EuRoC downloads are impossible from this image (no DNS, no raw
egress — probed and documented in BASELINE.md), so this proves the
real-data path per VERDICT r3 #2(b): a real-layout KITTI directory tree is
built from the only real photographs available (the reference's rectified
stereo fixture pair, /root/reference/libstereo-odometry/tests/0L.png|0R.png,
800x600, GT correspondence L(646,263)<->R(624,263) — see
computeSAD8_unittest.cpp:27), and `python -m rso.cli.demo --kitti` runs on
it end-to-end (loader + calib.txt parsing + native prefetch ring + jitted
engine + trajectory writer).

Two sequences, both with per-frame checks no synthetic render can fake:
  * static:  every frame is the identical real pair -> every estimated
    per-frame delta must be ~identity (zero-motion contract on real pixels).
  * panning: frame i is a 640x480 crop at x-offset 4*i of BOTH eyes — the
    same image-plane shift every frame, so the estimated per-frame deltas
    must be mutually consistent (~equal), mostly yaw.

Writes docs/artifacts/real_kitti_drive_r4.json.
Reference contract: demo-main.cpp:210-287 (the per-frame acquisition loop).
"""
import argparse
import json
import os
import subprocess
import sys
import tempfile

import numpy as np

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
FIX = "/root/reference/libstereo-odometry/tests"


def build_tree(root, n_frames, shift_px, crop=(640, 480)):
    """KITTI odometry layout: image_0/ image_1/ calib.txt times.txt."""
    from PIL import Image

    W, H = crop
    L = np.asarray(Image.open(os.path.join(FIX, "0L.png")).convert("L"))
    R = np.asarray(Image.open(os.path.join(FIX, "0R.png")).convert("L"))
    os.makedirs(os.path.join(root, "image_0"), exist_ok=True)
    os.makedirs(os.path.join(root, "image_1"), exist_ok=True)
    y0 = (L.shape[0] - H) // 2
    for i in range(n_frames):
        x0 = 8 + shift_px * i
        assert x0 + W <= L.shape[1], "crop walks off the image"
        Image.fromarray(L[y0:y0 + H, x0:x0 + W]).save(
            os.path.join(root, "image_0", f"{i:06d}.png"))
        Image.fromarray(R[y0:y0 + H, x0:x0 + W]).save(
            os.path.join(root, "image_1", f"{i:06d}.png"))
    # plausible Bumblebee-class calib (true intrinsics unpublished for the
    # fixture; they scale translation only — the checks below are
    # consistency checks, not absolute-scale checks)
    fx, cx, cy, base = 520.0, W / 2.0, H / 2.0, 0.12
    with open(os.path.join(root, "calib.txt"), "w") as f:
        f.write(f"P0: {fx} 0 {cx} 0 0 {fx} {cy} 0 0 0 1 0\n")
        f.write(f"P1: {fx} 0 {cx} {-fx * base} 0 {fx} {cy} 0 0 0 1 0\n")
    np.savetxt(os.path.join(root, "times.txt"),
               np.arange(n_frames) * 0.1, fmt="%.6f")


def run_demo(seq_dir, out_traj, frames):
    cmd = [sys.executable, "-m", "rso.cli.demo", "--kitti", seq_dir,
           "--frames", str(frames), "--out", out_traj]
    env = dict(os.environ)
    env["PYTHONPATH"] = ROOT + os.pathsep + env.get("PYTHONPATH", "")
    r = subprocess.run(cmd, capture_output=True, text=True, env=env,
                      timeout=1800)
    if r.returncode != 0:
        raise RuntimeError(f"demo failed:\n{r.stdout[-2000:]}"
                           f"\n{r.stderr[-2000:]}")
    return r.stdout


def deltas_of(traj_path):
    from rso.io.trajectory import read_kitti

    T = read_kitti(traj_path)
    return np.stack([np.linalg.inv(T[i - 1]) @ T[i]
                     for i in range(1, len(T))])


def rot_angle(D):
    return float(np.arccos(np.clip((np.trace(D[:3, :3]) - 1) / 2, -1, 1)))


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--frames", type=int, default=10)
    ap.add_argument("--shift", type=int, default=4)
    ap.add_argument("--keep-dir", default=None)
    ap.add_argument("--out", default=os.path.join(
        ROOT, "docs", "artifacts", "real_kitti_drive_r4.json"))
    args = ap.parse_args()
    sys.path.insert(0, ROOT)

    results = {}
    base = args.keep_dir or tempfile.mkdtemp(prefix="real_kitti_")
    for name, shift in (("static", 0), ("panning", args.shift)):
        seq = os.path.join(base, name)
        build_tree(seq, args.frames, shift)
        traj = os.path.join(seq, "traj.txt")
        log = run_demo(seq, traj, args.frames)
        # skip the first delta: frame 0 has no previous frame, so the demo
        # holds the pose (identity delta by construction, not a measurement)
        D = deltas_of(traj)[1:]
        t_norms = np.linalg.norm(D[:, :3, 3], axis=1)
        angs = np.array([rot_angle(d) for d in D])
        entry = {
            "frames": args.frames,
            "shift_px_per_frame": shift,
            "rot_deg_per_frame": [round(float(np.degrees(a)), 4)
                                  for a in angs],
            "trans_m_per_frame": [round(float(t), 4) for t in t_norms],
            "demo_tail": log.strip().splitlines()[-1],
        }
        if name == "static":
            entry["max_rot_deg"] = round(float(np.degrees(angs.max())), 5)
            entry["max_trans_m"] = round(float(t_norms.max()), 5)
            entry["pass"] = bool(angs.max() < np.radians(0.05)
                                 and t_norms.max() < 0.005)
        else:
            # identical shift each frame -> deltas must agree with their
            # own median (consistency, not absolute truth)
            med_a, med_t = np.median(angs), np.median(t_norms)
            entry["median_rot_deg"] = round(float(np.degrees(med_a)), 4)
            entry["median_trans_m"] = round(float(med_t), 4)
            entry["rot_spread"] = round(
                float(np.abs(angs - med_a).max() / max(med_a, 1e-9)), 3)
            entry["pass"] = bool(
                med_a > np.radians(0.05)   # it DID see the pan
                and np.abs(angs - med_a).max() < 0.35 * med_a)
        results[name] = entry
        print(json.dumps({name: entry}), flush=True)

    doc = {
        "what": "real-photograph KITTI-layout end-to-end drive "
                "(reference fixture pair 0L/0R; no dataset downloads "
                "possible: DNS and raw egress both blocked)",
        "fixture": f"{FIX}/0L.png|0R.png (800x600, real rectified stereo)",
        "all_pass": all(r["pass"] for r in results.values()),
        "results": results,
    }
    os.makedirs(os.path.dirname(args.out), exist_ok=True)
    with open(args.out, "w") as f:
        json.dump(doc, f, indent=1)
    print(f"wrote {args.out}")
    return 0 if doc["all_pass"] else 1


if __name__ == "__main__":
    sys.exit(main())
