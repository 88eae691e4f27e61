"""Final marginalization sweep: KEYFRAME RATE x window x {plain, marg}.

The one dimension rounds 2-4 did not sweep (VERDICT r4 #6): sparse
keyframes.  Theory: with a large inter-KF gap the VO odometry prior between
keyframes is weaker (drift accumulates across the gap) and each landmark is
seen by fewer active keyframes, so the evicted keyframe's absolute
information should matter most at (large gap, tight window).  If the dense
prior cannot win HERE, it cannot win anywhere in this pipeline and the
no-go is conclusive.

Usage: JAX_PLATFORMS=cpu \
           python tools/exp_marg_kfrate.py [--json OUT.json]
"""
import argparse
import json
import os
import sys

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
import numpy as np

from rso.ba.pipeline import VOWithBA
from rso.metrics.ate import ate_rmse
from rso.synthetic import make_sequence, synthetic_config


def run_ba(cfg, seq, window, gap, marg):
    vo = VOWithBA(cfg, seq.cam, max_keyframes=window, max_landmarks=768,
                  min_kf_gap=gap, marginalize=marg)
    poses = [np.eye(4)]
    n_kf = 0
    for l, r in seq.frames:
        out = vo.process_frame(l, r)
        poses.append(out.pose_wc)
        n_kf += int(out.is_keyframe)
    return np.stack(poses)[: len(seq.poses)], n_kf


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--frames", type=int, default=120)
    ap.add_argument("--speed", type=float, default=0.8)
    ap.add_argument("--json", default="")
    args = ap.parse_args()

    cfg = synthetic_config()
    rows = []
    for seed in (0, 1, 2):
        seq = make_sequence(n_frames=args.frames,
                            n_points=max(900, args.frames * 9), seed=seed,
                            speed=args.speed)
        for gap in (3, 8, 15):
            for window in (3, 4):
                pair = {}
                for marg in (False, True):
                    poses, n_kf = run_ba(cfg, seq, window, gap, marg)
                    pair["marg" if marg else "plain"] = float(
                        ate_rmse(poses, seq.poses))
                    kfs = n_kf
                d = pair["marg"] - pair["plain"]
                rows.append({"seed": seed, "gap": gap, "window": window,
                             "n_kf": kfs, **pair, "delta": d})
                print(f"seed {seed} gap {gap:>2} win {window} "
                      f"({kfs:>2} KFs): plain {pair['plain']:.4f} "
                      f"marg {pair['marg']:.4f}  d {d:+.4f}", flush=True)
    deltas = np.asarray([r["delta"] for r in rows])
    wins = int((deltas < -0.005).sum())
    print(f"\nmarg wins (>5mm better): {wins}/{len(rows)}; "
          f"median delta {np.median(deltas):+.4f} m; "
          f"max |delta| {np.abs(deltas).max():.4f} m", flush=True)
    if args.json:
        with open(args.json, "w") as f:
            json.dump({"rows": rows, "wins": wins,
                       "median_delta": float(np.median(deltas))}, f, indent=1)
        print(f"wrote {args.json}")


if __name__ == "__main__":
    main()
