"""rso-bench: per-frame throughput + accuracy benchmark on the current backend.

Measures steady-state frames/sec of the jitted step (compile excluded) on a
synthetic sequence, plus endpoint accuracy.  This is what the repo-root
bench.py wraps for the driver.
"""
from __future__ import annotations

import argparse
import json
import sys
import time

import numpy as np


def run_bench(n_frames: int = 120, n_points: int = 2000, warmup: int = 3,
              width: int = 1241, height: int = 376, repeat_passes: int = 3):
    import jax
    import jax.numpy as jnp

    from rso.engine import Engine
    from rso.geometry import pose_matrix
    from rso.metrics.ate import ate_rmse
    from rso.io.trajectory import integrate_relative
    from rso.synthetic import make_sequence, synthetic_config
    from rso.geometry.stereo_camera import StereoCamera

    cam = StereoCamera.make(fx_l=718.856, fy_l=718.856, cx_l=width / 2.0,
                            cy_l=height / 2.0, baseline=0.5371)
    seq = make_sequence(n_frames=n_frames, n_points=n_points, H=height,
                        W=width, cam=cam, speed=0.8)
    eng = Engine(synthetic_config(), seq.cam)

    # device-resident inputs, stacked for the chunked (one-dispatch) surface
    lefts = jax.device_put(jnp.stack([jnp.asarray(l) for l, _ in seq.frames]))
    rights = jax.device_put(jnp.stack([jnp.asarray(r) for _, r in seq.frames]))

    # warmup + compile (both surfaces)
    res = eng.process_frame(lefts[0], rights[0])
    eng.reset()
    results = eng.process_chunk(lefts, rights)
    jax.block_until_ready(results.pose)

    # device-resident initial state, reused across passes (re-creating it on
    # host re-uploads the whole state pytree through the device link)
    from rso.engine import init_state
    st_init = jax.device_put(init_state(eng.cfg, (height, width)))
    jax.block_until_ready(st_init.last_pose)

    # timed: Engine.process_chunk scans all frames in one dispatch, so the
    # number is sustained device throughput (the production offline-eval
    # path); best pass to shed sporadic host stalls
    pass_fps = []
    for _ in range(repeat_passes):
        eng.state = st_init
        t0 = time.perf_counter()
        results = eng.process_chunk(lefts, rights)
        jax.block_until_ready(results.pose)
        pass_fps.append(n_frames / (time.perf_counter() - t0))
    fps = max(pass_fps)

    # per-dispatch (live, frame-at-a-time) rate for reference; capped frame
    # count — each dispatch pays the full host/link round trip by design
    n_live = min(n_frames, 60)
    eng.reset()
    for i in range(warmup):
        res = eng.process_frame(lefts[i], rights[i])
    jax.block_until_ready(res.pose)
    eng.reset()
    t0 = time.perf_counter()
    for i in range(n_live):
        res = eng.process_frame(lefts[i], rights[i])
    jax.block_until_ready(res.pose)
    fps_live = n_live / (time.perf_counter() - t0)

    # pure device step time by scan-length slope (dispatch and chunk fixed
    # costs cancel).  The state and images are jit ARGUMENTS, not closure
    # captures: jax inlines closed-over arrays as dense constants in the
    # lowered module, which bloats the program and its compile time.
    from functools import partial as _partial

    from jax import lax as _lax0
    from rso.engine import make_step as _make_step

    _step = _make_step(eng.cfg, eng.cam, height, width)
    _st0 = jax.device_put(init_state(eng.cfg, (height, width)))
    _st0, _ = jax.jit(_step)(_st0, lefts[0], rights[0])
    _st0 = jax.block_until_ready(_st0)

    @_partial(jax.jit, static_argnames=("n",))
    def _slope_run(st0, imgs, n):
        def body(carry, _):
            st, flip = carry
            l = jnp.where(flip, imgs[0], imgs[2])
            r = jnp.where(flip, imgs[1], imgs[3])
            st, _res = _step(st, l, r)
            return (st, ~flip), None

        return _lax0.scan(body, (st0, jnp.bool_(True)), None, length=n)[0]

    _imgs = jnp.stack([lefts[0], rights[0], lefts[1], rights[1]])

    def _t(n):
        jax.block_until_ready(_slope_run(_st0, _imgs, n))
        best = 1e9
        for _ in range(3):
            t0 = time.perf_counter()
            jax.block_until_ready(_slope_run(_st0, _imgs, n))
            best = min(best, time.perf_counter() - t0)
        return best

    step_ms_device = (_t(120) - _t(20)) / 100 * 1e3

    # accuracy pass (host-integrated trajectory from the chunked results —
    # identical math to per-frame calls).  ATE over a fixed 120-frame window
    # so the number stays comparable when n_frames changes (drift grows with
    # trajectory length).
    eng.reset()
    results = eng.process_chunk(lefts, rights)
    rel_poses = np.asarray(results.pose)
    valids = np.asarray(results.valid)
    n_ate = min(n_frames, 120)
    T = np.eye(4)
    poses = [T.copy()]
    last_delta = None
    for k in range(n_ate):
        if valids[k]:
            last_delta = np.asarray(pose_matrix(rel_poses[k]))
        # constant-velocity coast over invalid frames (standard VO
        # evaluation practice: the engine reports the gap honestly via
        # result.valid, the trajectory bridges it with the motion prior)
        if last_delta is not None:
            T = T @ last_delta
        poses.append(T.copy())
    ate = ate_rmse(np.stack(poses)[: n_ate + 1], seq.poses[: n_ate + 1])

    # BA iterations/sec (the BASELINE.json BA metric), single chip
    from rso.ba import BAProblem, bundle_adjust
    from rso.ba.ba import _project_grid
    import numpy as _np
    rng = _np.random.default_rng(0)
    P, L = 8, 1024
    poses0 = jnp.zeros((P, 6), jnp.float32).at[:, 5].set(
        jnp.arange(P, dtype=jnp.float32) * -0.4)
    lmks0 = jnp.asarray(_np.stack([rng.uniform(-10, 10, L),
                                   rng.uniform(-5, 5, L),
                                   rng.uniform(5, 40, L)], -1), jnp.float32)
    obs, _, _ = _project_grid(seq.cam, poses0, lmks0)
    prob = BAProblem(poses=poses0 + 0.01, lmks=lmks0 + 0.05, obs=obs,
                     mask=jnp.ones((P, L), bool))
    # max_iters SLOPE, not a single timed call: the slope cancels the fixed
    # dispatch cost of one call.
    ba_fns = {n: jax.jit(lambda pr, n=n: bundle_adjust(
        seq.cam, pr, max_iters=n, tol=0.0).poses) for n in (25, 75)}
    for f in ba_fns.values():   # compile both trip counts
        jax.block_until_ready(f(prob))

    def _ba_t(n):
        best = 1e9
        for _ in range(3):
            t0 = time.perf_counter()
            jax.block_until_ready(ba_fns[n](prob))
            best = min(best, time.perf_counter() - t0)
        return best

    ba_iters_per_sec = 50.0 / (_ba_t(75) - _ba_t(25))

    # detect-stage HBM accounting (the step's largest stage).  Detection is
    # bandwidth-bound, not FLOP-bound (its only "matmuls" are 3x3 box sums),
    # so speed-of-light is HBM bytes, not MXU FLOPs.  Byte model per f32
    # image pass over H*W px: FAST bit-pack reads the image once and writes
    # two u32 mask planes (3 passes), Shi-Tomasi writes+reads gx,gy, runs two
    # separable box-sum sweeps over three products and writes the response
    # (~8 passes), NMS reduce_window + masked select reads/writes the
    # response (3 passes), top-K reads it once (1 pass) => ~15 f32-plane
    # passes.
    from jax import lax as _lax

    from rso.frontend.detect import detect_features

    img0 = jnp.asarray(seq.frames[0][0], jnp.float32)

    def _det(img):
        f = detect_features(img, eng.cfg.detect,
                            eng.cfg.engine.max_kps_per_octave, jnp.int32(20),
                            False, arc=eng.cfg.engine.fast_arc,
                            topk_recall=eng.cfg.engine.topk_recall)
        return f.response.sum()

    @_partial(jax.jit, static_argnames=("n",))
    def _det_run(img, n):
        # img is an argument (not a closure capture) — see _slope_run above
        def body(c, _):
            return c + _det(img + c * jnp.float32(1e-9)), None

        return _lax.scan(body, jnp.float32(0), None, length=n)[0]

    def _t_of(n, passes=3):
        jax.block_until_ready(_det_run(img0, n))
        best = 1e9
        for _ in range(passes):
            t0 = time.perf_counter()
            jax.block_until_ready(_det_run(img0, n))
            best = min(best, time.perf_counter() - t0)
        return best

    detect_s = max((_t_of(90) - _t_of(30)) / 60.0, 1e-9)
    model_passes = 15
    detect_bytes = model_passes * width * height * 4
    detect_gbps = detect_bytes / detect_s / 1e9

    return {
        "fps": fps,
        "fps_live_per_dispatch": fps_live,
        "step_ms_device": step_ms_device,
        "fps_device_step": 1e3 / step_ms_device,
        "ba_iters_per_sec": ba_iters_per_sec,
        "ate_rmse_m": ate,
        "detect_ms_per_image": detect_s * 1e3,
        "detect_hbm_gbps_model": detect_gbps,
        "n_frames": n_frames,
        "image": f"{width}x{height}",
        "backend": jax.default_backend(),
        "device": str(jax.devices()[0]),
        "device_kind": jax.devices()[0].device_kind,
        "device_count": len(jax.devices()),
    }


def main(argv=None):
    p = argparse.ArgumentParser("rso-bench", description=__doc__)
    p.add_argument("--frames", type=int, default=60)
    p.add_argument("--points", type=int, default=2000)
    p.add_argument("--width", type=int, default=1241)
    p.add_argument("--height", type=int, default=376)
    p.add_argument("--passes", type=int, default=3)
    args = p.parse_args(argv)
    from rso import compile_cache

    compile_cache.enable()
    out = run_bench(args.frames, args.points, width=args.width,
                    height=args.height, repeat_passes=args.passes)
    print(json.dumps(out))
    return 0


if __name__ == "__main__":
    sys.exit(main())
