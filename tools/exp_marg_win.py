"""Where does marginalization beat plain eviction?  Small windows + landmark
churn: with a large window (round-1 used 8 KFs) the active problem retains
enough redundancy that dropping the oldest keyframe's factors costs nothing
measurable; with a tight window each landmark is observed by only a few
active keyframes, so the evicted information matters.

Sweep: window size x {plain, marg} x seeds on the corridor scene.
Usage: JAX_PLATFORMS=cpu python tools/exp_marg_win.py
"""
import sys, os
sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
import numpy as np

from rso.ba.pipeline import VOWithBA
from rso.geometry import pose_matrix
from rso.metrics.ate import ate_rmse
from rso.synthetic import make_sequence, synthetic_config


def run_ba(cfg, seq, window, marg):
    vo = VOWithBA(cfg, seq.cam, max_keyframes=window, max_landmarks=768,
                  marginalize=marg)
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
        for window in (3, 4, 8):
            for marg in (False, True):
                poses = run_ba(cfg, seq, window, marg)
                a = ate_rmse(poses, seq.poses)
                print(f"seed {seed} window {window} marg {int(marg)}: "
                      f"ATE {a:.4f}", flush=True)


if __name__ == "__main__":
    main()
