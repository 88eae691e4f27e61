"""Compiled-program payload regression guard.

jax inlines closed-over / numpy-constant arrays as dense<...> literals in
the lowered module — an 8.4 MB pyramid pool matrix once crept into every
step program this way (fixed by the iota formulation,
rso/frontend/pyramid.py).  Multi-MB constants cost parse and compile time
on every compile.  The guard exports the step for CUDA (lowering is a
host-side transformation, so it runs on a CPU).
"""
import jax
import jax.numpy as jnp
import pytest

# The default step lowers to about 1.4 MB and the flow-mode step (more ops:
# LK levels + integer seed unfold) to about 3.2 MB with no inlined-constant
# bloat; the limit catches multi-MB constants with headroom.
LIMIT_MB = 4.0


def export_step_for_cuda(cfg, H=376, W=1241):
    from rso.engine import init_state, make_step
    from rso.geometry.stereo_camera import StereoCamera

    cam = StereoCamera.make(fx_l=718.856, fy_l=718.856, cx_l=W / 2.0,
                            cy_l=H / 2.0, baseline=0.5371)
    step = make_step(cfg, cam, H, W)
    st_spec = jax.tree.map(lambda x: jax.ShapeDtypeStruct(x.shape, x.dtype),
                           init_state(cfg, (H, W)))
    img_spec = jax.ShapeDtypeStruct((H, W), jnp.uint8)
    return jax.export.export(jax.jit(step), platforms=["cuda"])(
        st_spec, img_spec, img_spec)


@pytest.mark.parametrize("flow", [False, True])
def test_step_program_mlir_stays_small(flow):
    import dataclasses

    from rso.config import IFMatchMethod
    from rso.synthetic import synthetic_config

    cfg = synthetic_config()
    if flow:
        cfg = cfg.replace(if_match=dataclasses.replace(
            cfg.if_match, ifm_method=IFMatchMethod.OPTICAL_FLOW))
    text = export_step_for_cuda(cfg).mlir_module()
    size_mb = len(text) / 1e6
    assert size_mb < LIMIT_MB, (
        f"step program is {size_mb:.2f} MB of MLIR (limit {LIMIT_MB}); a "
        f"large inlined constant probably crept in — express it with iotas "
        f"or pass it as an argument (see rso/frontend/pyramid.py)")
