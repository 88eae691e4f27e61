"""Last targeted attempt at a marginalization win: landmark churn.

exp_marg_win.py (blob scene, windows 3/4/8) and exp_marg_noodom.py
(odometry prior removed) both put marginalization within noise of plain
eviction.  The remaining classical win scenario is high landmark churn:
a tight window on a fast, turning corridor where each landmark is seen
by only ~2 active keyframes, so the evicted keyframe's factors are a
large fraction of what constrained the survivors.

Sweep: textured corridor, window 3, {slow/straight, fast/turning} x
{plain, marg} x seeds.
Usage: JAX_PLATFORMS=cpu python tools/exp_marg_churn.py [n]
"""
import os
import sys

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
import numpy as np

from rso.ba.pipeline import VOWithBA
from rso.metrics.ate import ate_rmse
from rso.synthetic import make_textured_sequence, textured_config


def run_ba(cfg, seq, window, marg):
    vo = VOWithBA(cfg, seq.cam, max_keyframes=window, max_landmarks=768,
                  marginalize=marg)
    poses = [np.eye(4)]
    for l, r in seq.frames:
        out = vo.process_frame(l, r)
        poses.append(out.pose_wc)
    return np.stack(poses)[: len(seq.poses)]


def main():
    n = int(sys.argv[1]) if len(sys.argv) > 1 else 60
    cfg = textured_config()
    for seed in (0, 1):
        for speed, yaw, tag in ((0.25, 0.004, "slow-straight"),
                                (0.6, 0.02, "fast-turning")):
            seq = make_textured_sequence(n_frames=n, seed=seed, speed=speed,
                                         yaw_rate=yaw)
            for marg in (False, True):
                poses = run_ba(cfg, seq, 3, marg)
                a = ate_rmse(poses, seq.poses)
                print(f"seed {seed} {tag:14s} marg {int(marg)}: ATE {a:.4f}",
                      flush=True)


if __name__ == "__main__":
    main()
