"""Validate subpixel_track_refine on gradient-rich (textured) imagery.

The knob ships off-by-default with a note that it is accuracy-neutral on
blob scenes (match-structure-limited) and "expected to help on real
imagery".  The textured corridor is the real-image-statistics scene: A/B
the knob across seeds and speeds there.

Usage: JAX_PLATFORMS=cpu python tools/exp_refine_texture.py [n]
"""
import dataclasses
import os
import sys

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
import numpy as np


def main():
    import jax.numpy as jnp

    from rso.engine import Engine
    from rso.geometry.se3 import pose_matrix
    from rso.metrics.ate import ate_rmse
    from rso.synthetic import make_textured_sequence, textured_config

    n = int(sys.argv[1]) if len(sys.argv) > 1 else 40
    base = textured_config()
    for seed in (0, 1, 2):
        for speed in (0.25, 0.5):
            seq = make_textured_sequence(n_frames=n, seed=seed, speed=speed)
            line = f"seed {seed} speed {speed}:"
            for refine in (False, True):
                cfg = base.replace(engine=dataclasses.replace(
                    base.engine, subpixel_track_refine=refine))
                eng = Engine(cfg, seq.cam)
                T = np.eye(4)
                poses = [T.copy()]
                for l, r in seq.frames:
                    res = eng.process_frame(l, r)
                    T = T @ np.asarray(pose_matrix(jnp.asarray(res.pose)))
                    poses.append(T.copy())
                a = ate_rmse(np.stack(poses)[: len(seq.poses)], seq.poses)
                line += f"  refine={int(refine)} ATE {a:.4f}"
            print(line, flush=True)


if __name__ == "__main__":
    main()
