"""Can subpixel refine shed window evals without losing its ATE win?

refine_positions did 5 in-patch window evaluations per call (3 GN
iterations + 2 SSD evals for the acceptance gate) x 2 eyes x 3 octaves =
+0.74 ms/step in the dataset presets.  This A/Bs trimmed schedules on the
textured corridor (the scene where the knob earns its 6-15% ATE win) via
the EngineParams.refine_iters / refine_ssd_gate knobs this experiment
motivated (measured result: every trimmed variant keeps the full win —
0.021-0.023 m vs 0.039 m unrefined — so iters=2 gate-free shipped as the
default; its step cost on the GPU is not measured).

Usage: JAX_PLATFORMS=cpu python tools/exp_refine_trim.py [n_frames]
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

    # (refine_on, iters, ssd_gate)
    variants = {
        "off": (False, 3, True),
        "on(i3,gate)": (True, 3, True),
        "on(i2,gate)": (True, 2, True),
        "on(i3,nogate)": (True, 3, False),
        "on(i2,nogate)": (True, 2, False),
    }
    results = {k: [] for k in variants}
    for seed in (0, 1, 2):
        seq = make_textured_sequence(n_frames=n, seed=seed, speed=0.5)
        for name, (on, iters, gate) in variants.items():
            cfg = base.replace(engine=dataclasses.replace(
                base.engine, subpixel_track_refine=on, refine_iters=iters,
                refine_ssd_gate=gate))
            eng = Engine(cfg, seq.cam)
            T = np.eye(4)
            poses = [T.copy()]
            nval = 0
            for l, r in seq.frames:
                res = eng.process_frame(l, r)
                if bool(res.valid):
                    nval += 1
                T = T @ np.asarray(pose_matrix(jnp.asarray(res.pose)))
                poses.append(T.copy())
            a = ate_rmse(np.stack(poses)[1:], seq.poses)
            results[name].append(a)
            print(f"seed {seed} {name:>14}: ATE {a:.4f} m ({nval}/{n})",
                  flush=True)
    print()
    for name, vals in results.items():
        arr = np.asarray(vals)
        print(f"{name:>14}: mean {arr.mean():.4f}  max {arr.max():.4f}")


if __name__ == "__main__":
    main()
