"""rso-stages: per-stage device timing report (profiler parity tool).

The production step is one fused XLA program (per-stage spans cannot be
timed inside it), so this tool compiles each stage separately and reports
steady-state device times with the reference's span names (`_stg1`..`_stg5`,
cf. its CTimeLogger report printed on destruction).
"""
from __future__ import annotations

import argparse
import sys
import time

import numpy as np


def main(argv=None):
    p = argparse.ArgumentParser("rso-stages", description=__doc__)
    p.add_argument("--width", type=int, default=1241)
    p.add_argument("--height", type=int, default=376)
    p.add_argument("--points", type=int, default=2000)
    p.add_argument("--iters", type=int, default=30)
    args = p.parse_args(argv)
    from rso import compile_cache

    compile_cache.enable()

    import jax
    import jax.numpy as jnp

    from rso.config import LeastSquaresParams
    from rso.engine import init_state, make_step
    from rso.frontend.detect import detect_features
    from rso.frontend.pyramid import build_pyramid, to_grayscale
    from rso.frontend.stereo_match import match_left_right
    from rso.frontend.track import track_interframe
    from rso.geometry.stereo_camera import StereoCamera
    from rso.metrics.profiler import SpanProfiler
    from rso.solver.robust_gn import solve_pose
    from rso.synthetic import make_sequence, synthetic_config

    H, W = args.height, args.width
    cam = StereoCamera.make(fx_l=718.856, fy_l=718.856, cx_l=W / 2.0,
                            cy_l=H / 2.0, baseline=0.5371)
    seq = make_sequence(n_frames=2, n_points=args.points, H=H, W=W, cam=cam)
    cfg = synthetic_config()
    K = cfg.engine.max_kps_per_octave
    O = cfg.n_octaves

    img_l = jax.device_put(jnp.asarray(seq.frames[0][0]))
    img_r = jax.device_put(jnp.asarray(seq.frames[0][1]))
    prof = SpanProfiler()

    def timed(name, fn, *xs):
        out = fn(*xs)
        jax.block_until_ready(out)
        for _ in range(args.iters):
            with prof.span(name):
                out = fn(*xs)
                jax.block_until_ready(out)
        return out

    pyr_fn = jax.jit(lambda a, b: (build_pyramid(to_grayscale(a), O),
                                   build_pyramid(to_grayscale(b), O)))
    pyr_l, pyr_r = timed("_stg1 (rectify+pyramid)", pyr_fn, img_l, img_r)

    det = jax.jit(lambda im: detect_features(im, cfg.detect, K, jnp.int32(20),
                                             False, arc=cfg.engine.fast_arc))
    feats = []
    for o in range(O):
        fl = timed(f"_stg2 detect.oct={o} L", det, pyr_l[o])
        fr = timed(f"_stg2 detect.oct={o} R", det, pyr_r[o])
        feats.append((fl, fr))

    mm = jax.jit(lambda a, b: match_left_right(a, b, cfg.lr_match, W, 0.0))
    matches = [timed(f"_stg3 match.oct={o}", mm, *feats[o]) for o in range(O)]

    trk = jax.jit(lambda fl, fr, m: track_interframe(
        fl, fr, m, fl, fr, m, cfg.if_match, jax.random.PRNGKey(0),
        cfg.engine.ransac_iters, cfg.engine.ransac_threshold))
    for o in range(O):
        timed(f"_stg4 track.oct={o}", trk, *feats[o], matches[o])

    rng = np.random.default_rng(0)
    prev = jnp.asarray(rng.uniform(100, 1000, (O * K, 4)), jnp.float32)
    cur = prev + 2.0
    mask = jnp.ones(O * K, bool)
    sv = jax.jit(lambda a, b, m: solve_pose(cam, a, b, m, LeastSquaresParams()))
    timed("_stg5 (robust GN)", sv, prev, cur, mask)

    step = jax.jit(make_step(cfg, cam, H, W))
    st = init_state(cfg)
    st, _ = step(st, img_l, img_r)
    timed("processNewImagePair (fused)", lambda s: step(s, img_l, img_r)[1].pose, st)

    # pipelined throughput: back-to-back async dispatch, block once at the end
    s_ = st
    s_, res = step(s_, img_l, img_r)
    jax.block_until_ready(res.pose)
    t0 = time.time()
    for _ in range(args.iters):
        s_, res = step(s_, img_l, img_r)
    jax.block_until_ready(res.pose)
    pipelined_ms = 1e3 * (time.time() - t0) / args.iters

    print(f"backend: {jax.default_backend()} {jax.devices()[0]}")
    prof.report()
    print(f"\n{'fused step, pipelined':<40}{args.iters:>8}"
          f"{pipelined_ms:>12.3f}")
    print("\nnotes: per-span numbers include one host<->device round trip "
          "each (compare against the pipelined fused-step line); standalone stage "
          "timings also exceed the fused step because the production graph "
          "fuses across stages.")
    return 0


if __name__ == "__main__":
    sys.exit(main())
