"""Marginalization vs plain eviction WITHOUT the odometry prior.

Hypothesis from exp_marg_win.py (round 2): marginalization is within noise
of plain eviction because the weak odometry prior already anchors every
consecutive-KF pair, which is most of what the evicted keyframe's factors
constrained.  Removing the odometry prior (rel_w=0) isolates the
marginalization prior's contribution.

Usage: JAX_PLATFORMS=cpu python tools/exp_marg_noodom.py [n_frames]
"""
import os
import sys

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
import numpy as np

from rso.ba.pipeline import VOWithBA
from rso.metrics.ate import ate_rmse
from rso.synthetic import make_sequence, synthetic_config


def run_ba(cfg, seq, window, marg, rel_w):
    vo = VOWithBA(cfg, seq.cam, max_keyframes=window, max_landmarks=768,
                  marginalize=marg, rel_w_rot=rel_w[0], rel_w_trans=rel_w[1])
    poses = [np.eye(4)]
    for l, r in seq.frames:
        out = vo.process_frame(l, r)
        poses.append(out.pose_wc)
    return np.stack(poses)[: len(seq.poses)]


def main():
    n = int(sys.argv[1]) if len(sys.argv) > 1 else 120
    cfg = synthetic_config()
    for seed in (0, 1, 2):
        seq = make_sequence(n_frames=n, n_points=max(900, n * 9), seed=seed,
                            speed=0.5)
        for rel_w, tag in (((0.0, 0.0), "no-odom"), ((4.0e2, 25.0), "odom")):
            for marg in (False, True):
                poses = run_ba(cfg, seq, 3, marg, rel_w)
                a = ate_rmse(poses, seq.poses)
                print(f"seed {seed} {tag:7s} marg {int(marg)}: ATE {a:.4f}",
                      flush=True)


if __name__ == "__main__":
    main()
