"""Drive the FULL Malaga source path on real photographs: Malaga-layout tree
-> load_malaga -> prefetch ring -> rso-demo AND rso-fleet -> trajectories.

The Malaga Urban extracts cannot be downloaded from this image (no DNS, no
raw egress — probed in BASELINE.md), so this mirrors what
tools/real_kitti_drive.py does for KITTI: a real-layout Malaga directory
tree (`<root>/Images/img_CAMERA1_<unix_ts>_left.jpg` pairs, the extract
layout BASELINE.json config #4 names) is built from the only real
photographs available (the reference's rectified stereo fixture pair,
/root/reference/libstereo-odometry/tests/0L.png|0R.png, 800x600), and both
CLI surfaces that advertise --malaga run on it end-to-end.

Per-sequence checks on real pixels:
  * static:  identical real pair every frame -> per-frame deltas ~identity.
  * panning: same x-crop shift of both eyes every frame -> deltas must be
    mutually consistent (~equal), mostly yaw.
Fleet check: the 2-sequence DP sweep writes both trajectories and its
static-arm trajectory matches the demo's static contract.

Writes docs/artifacts/real_malaga_drive_r5.json.
Reference contract: the image-dir source, demo-main.cpp:122-146.
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
    """Malaga extract layout: Images/img_CAMERA1_<ts>_{left,right}.jpg."""
    from PIL import Image

    W, H = crop
    L = np.asarray(Image.open(os.path.join(FIX, "0L.png")).convert("L"))
    R = np.asarray(Image.open(os.path.join(FIX, "0R.png")).convert("L"))
    d = os.path.join(root, "Images")
    os.makedirs(d, exist_ok=True)
    y0 = (L.shape[0] - H) // 2
    t0 = 1261228749.918590  # the real extracts' unix-time filename clock
    for i in range(n_frames):
        x0 = 8 + shift_px * i
        assert x0 + W <= L.shape[1], "crop walks off the image"
        ts = t0 + i * 0.05
        Image.fromarray(L[y0:y0 + H, x0:x0 + W]).save(
            os.path.join(d, f"img_CAMERA1_{ts:.6f}_left.jpg"), quality=97)
        Image.fromarray(R[y0:y0 + H, x0:x0 + W]).save(
            os.path.join(d, f"img_CAMERA1_{ts:.6f}_right.jpg"), quality=97)


def _env():
    env = dict(os.environ)
    env["PYTHONPATH"] = ROOT + os.pathsep + env.get("PYTHONPATH", "")
    return env


def run_demo(seq_dir, out_traj, frames):
    cmd = [sys.executable, "-m", "rso.cli.demo", "--malaga", seq_dir,
           "--frames", str(frames), "--out", out_traj]
    r = subprocess.run(cmd, capture_output=True, text=True, env=_env(),
                       timeout=1800)
    if r.returncode != 0:
        raise RuntimeError(f"demo failed:\n{r.stdout[-2000:]}"
                           f"\n{r.stderr[-2000:]}")
    return r.stdout


def run_fleet(seq_dirs, out_dir, frames, chunk):
    cmd = [sys.executable, "-m", "rso.cli.fleet",
           "--frames", str(frames), "--chunk", str(chunk),
           "--out-dir", out_dir]
    for d in seq_dirs:
        cmd += ["--malaga", d]
    r = subprocess.run(cmd, capture_output=True, text=True, env=_env(),
                       timeout=1800)
    if r.returncode != 0:
        raise RuntimeError(f"fleet failed:\n{r.stdout[-2000:]}"
                           f"\n{r.stderr[-2000:]}")
    return r.stdout


def deltas_of(traj_path):
    from rso.io.trajectory import read_kitti

    T = read_kitti(traj_path)
    return np.stack([np.linalg.inv(T[i - 1]) @ T[i]
                     for i in range(1, len(T))])


def rot_angle(D):
    return float(np.arccos(np.clip((np.trace(D[:3, :3]) - 1) / 2, -1, 1)))


def check(name, traj):
    # frame 0 has no previous frame: its delta is identity by construction
    D = deltas_of(traj)[1:]
    t_norms = np.linalg.norm(D[:, :3, 3], axis=1)
    angs = np.array([rot_angle(d) for d in D])
    entry = {"rot_deg_per_frame": [round(float(np.degrees(a)), 4)
                                   for a in angs],
             "trans_m_per_frame": [round(float(t), 4) for t in t_norms]}
    if name == "static":
        entry["max_rot_deg"] = round(float(np.degrees(angs.max())), 5)
        entry["max_trans_m"] = round(float(t_norms.max()), 5)
        entry["pass"] = bool(angs.max() < np.radians(0.05)
                             and t_norms.max() < 0.005)
    else:
        med_a = np.median(angs)
        entry["median_rot_deg"] = round(float(np.degrees(med_a)), 4)
        entry["median_trans_m"] = round(float(np.median(t_norms)), 4)
        entry["rot_spread"] = round(
            float(np.abs(angs - med_a).max() / max(med_a, 1e-9)), 3)
        entry["pass"] = bool(med_a > np.radians(0.05)
                             and np.abs(angs - med_a).max() < 0.35 * med_a)
    return entry


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--frames", type=int, default=10)
    ap.add_argument("--shift", type=int, default=4)
    ap.add_argument("--keep-dir", default=None)
    ap.add_argument("--out", default=os.path.join(
        ROOT, "docs", "artifacts", "real_malaga_drive_r5.json"))
    args = ap.parse_args()
    sys.path.insert(0, ROOT)

    results = {}
    base = args.keep_dir or tempfile.mkdtemp(prefix="real_malaga_")
    seq_dirs = {}
    for name, shift in (("static", 0), ("panning", args.shift)):
        seq = os.path.join(base, name)
        build_tree(seq, args.frames, shift)
        seq_dirs[name] = seq
        traj = os.path.join(seq, "traj.txt")
        log = run_demo(seq, traj, args.frames)
        entry = check(name, traj)
        entry["frames"] = args.frames
        entry["shift_px_per_frame"] = shift
        entry["demo_tail"] = log.strip().splitlines()[-1]
        results[f"demo_{name}"] = entry
        print(json.dumps({f"demo_{name}": entry}), flush=True)

    # fleet: both sequences in one DP sweep
    fdir = os.path.join(base, "fleet_out")
    flog = run_fleet([seq_dirs["static"], seq_dirs["panning"]], fdir,
                     args.frames, chunk=max(2, args.frames // 2))
    trajs = sorted(os.listdir(fdir))
    fentry = {"trajectories": trajs,
              "summary_tail": flog.strip().splitlines()[-1]}
    stat = [t for t in trajs if "static" in t]
    pan = [t for t in trajs if "panning" in t]
    fentry["static"] = check("static", os.path.join(fdir, stat[0]))
    fentry["panning"] = check("panning", os.path.join(fdir, pan[0]))
    fentry["pass"] = bool(len(trajs) == 2 and fentry["static"]["pass"]
                          and fentry["panning"]["pass"])
    results["fleet"] = fentry
    print(json.dumps({"fleet": {k: fentry[k] for k in
                                ("trajectories", "pass")}}), flush=True)

    doc = {
        "what": "real-photograph Malaga-layout end-to-end drive of the demo "
                "AND fleet CLI --malaga surfaces (no dataset downloads "
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
