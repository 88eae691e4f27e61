"""e2e ATE at topk_recall 0.95 vs 1.00, 3 scene seeds, default SAD mode.
Decision data for EngineParams.topk_recall (the accuracy side; on a GPU
approx_max_k is an exact top-k at any recall target)."""
import sys, os, time
sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
import dataclasses
import numpy as np


def main():
    import jax, jax.numpy as jnp
    from rso.engine import Engine
    from rso.geometry import pose_matrix
    from rso.metrics.ate import ate_rmse
    from rso.geometry.stereo_camera import StereoCamera
    from rso.synthetic import make_sequence, synthetic_config

    W, H, N = 1241, 376, 60
    cam = StereoCamera.make(fx_l=718.856, fy_l=718.856, cx_l=W/2.0,
                            cy_l=H/2.0, baseline=0.5371)
    for seed in (0, 1, 2):
        seq = make_sequence(n_frames=N, n_points=N*17, H=H, W=W, cam=cam,
                            speed=0.8, seed=seed)
        L = jnp.stack([jnp.asarray(l) for l, _ in seq.frames])
        R = jnp.stack([jnp.asarray(r) for _, r in seq.frames])
        for recall in (0.95, 1.0):
            cfg = synthetic_config()
            cfg = cfg.replace(engine=dataclasses.replace(cfg.engine,
                                                      topk_recall=recall))
            eng = Engine(cfg, cam)
            res = eng.process_chunk(L, R)
            rel = np.asarray(res.pose); ok = np.asarray(res.valid)
            T = np.eye(4); est = [T.copy()]; last = None
            for k in range(N):
                if ok[k]:
                    last = np.asarray(pose_matrix(rel[k]))
                if last is not None:
                    T = T @ last
                est.append(T.copy())
            a = ate_rmse(np.asarray(est[:N]), seq.poses)
            print(f"seed {seed} recall {recall}: ATE {a:.4f} "
                  f"valid {int(ok.sum())}/{N}", flush=True)


if __name__ == "__main__":
    main()
