"""BA gains on real-texture imagery: pure VO vs window BA, textured corridor.

Round-1 BA improvements (2.5-4.4x ATE) were measured on blob corridor
scenes only; this runs the same VO-vs-VO+BA comparison on the textured
corridor (photographic surface statistics).

Usage: JAX_PLATFORMS=cpu python tools/eval_ba_textured.py [n]
"""
import os
import sys

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
import numpy as np

from rso.ba.pipeline import VOWithBA
from rso.engine import Engine
from rso.geometry import pose_matrix
from rso.metrics.ate import ate_rmse
from rso.synthetic import make_textured_sequence, textured_config


def run_vo(cfg, seq):
    eng = Engine(cfg, seq.cam)
    T = np.eye(4)
    poses = [T.copy()]
    for l, r in seq.frames:
        res = eng.process_frame(l, r)
        if bool(res.valid):
            T = T @ np.asarray(pose_matrix(res.pose))
        poses.append(T.copy())
    return np.stack(poses)[: len(seq.poses)]


def run_ba(cfg, seq):
    vo = VOWithBA(cfg, seq.cam, max_keyframes=8, max_landmarks=768)
    poses = [np.eye(4)]
    for l, r in seq.frames:
        out = vo.process_frame(l, r)
        poses.append(out.pose_wc)
    return np.stack(poses)[: len(seq.poses)]


def main():
    n = int(sys.argv[1]) if len(sys.argv) > 1 else 120
    cfg = textured_config()
    for seed in (0, 1, 2):
        seq = make_textured_sequence(n_frames=n, seed=seed, speed=0.5,
                                     yaw_rate=0.004)
        path = float(np.sum(np.linalg.norm(
            np.diff(seq.poses[:, :3, 3], axis=0), axis=1)))
        a_vo = ate_rmse(run_vo(cfg, seq), seq.poses)
        a_ba = ate_rmse(run_ba(cfg, seq), seq.poses)
        print(f"seed {seed} path {path:.0f}m: VO {a_vo:.4f}  VO+BA {a_ba:.4f}"
              f"  ({a_vo / max(a_ba, 1e-9):.2f}x)", flush=True)


if __name__ == "__main__":
    main()
