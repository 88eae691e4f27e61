"""Data-parallel multi-sequence evaluation (SURVEY.md section 2.5 DP row).

Within a sequence, frame t depends on t-1 (the prev-frame state and pose warm
start), so DP happens across *sequences*: the whole jitted step vmaps over a
batch of independent engine states, and the batch axis shards over a device
mesh — offline benchmark sweeps (KITTI 00-10) run as one program over all
local devices.  The vmapped step runs under shard_map, so every device
steps only its own sequences and nothing crosses devices inside the step
(nor can a custom call in the step, which the SPMD partitioner cannot
split, force a gather).
"""
from __future__ import annotations

import numpy as np
import jax
import jax.numpy as jnp
from jax.sharding import Mesh, NamedSharding, PartitionSpec as P

from rso.config import RSOConfig
from rso.engine import EngineState, init_state, make_step
from rso.geometry.stereo_camera import StereoCamera


class BatchEngine:
    """Run B independent sequences through one vmapped, mesh-sharded step."""

    def __init__(self, cfg: RSOConfig, cam: StereoCamera, batch: int,
                 img_h: int, img_w: int, mesh: Mesh | None = None,
                 rectify_maps=None):
        if mesh is None:
            # use every local device that evenly divides the batch
            n_dev = len(jax.devices())
            use = n_dev if batch % n_dev == 0 else 1
            mesh = Mesh(np.array(jax.devices()[:use]), axis_names=("seq",))
        self.mesh = mesh
        self.batch = batch
        self.cfg = cfg
        self._shard = NamedSharding(mesh, P("seq"))
        step = make_step(cfg, cam, img_h, img_w, rectify_maps=rectify_maps)
        self._raw_step = step
        self._step = jax.jit(self._per_device(jax.vmap(step), P("seq")))
        self._chunk = None
        st = init_state(cfg)
        self.states = jax.device_put(
            jax.tree_util.tree_map(
                lambda x: jnp.broadcast_to(x, (batch,) + x.shape), st),
            NamedSharding(mesh, P("seq")))

    def _per_device(self, f, out_spec):
        """f over each device's shard of the 'seq' axis.  check_vma is off:
        the step's solver loops carry scalars that are per-sequence values,
        not mesh-replicated ones."""
        return jax.shard_map(f, mesh=self.mesh, in_specs=P("seq"),
                             out_specs=out_spec, check_vma=False)

    def process_frames(self, lefts: np.ndarray, rights: np.ndarray):
        """lefts/rights: [B,H,W] u8 — one frame per sequence."""
        lefts = jax.device_put(jnp.asarray(lefts), self._shard)
        rights = jax.device_put(jnp.asarray(rights), self._shard)
        self.states, results = self._step(self.states, lefts, rights)
        return results

    def process_chunk(self, lefts: np.ndarray, rights: np.ndarray):
        """lefts/rights: [B,N,H,W] u8 — N frames of each sequence in ONE
        device dispatch: lax.scan over frames of the vmapped step (the
        sequences-sharded analogue of Engine.process_chunk).  Sequence
        state stays resident/sharded across the whole chunk; results come
        back stacked [N,B,...] along the frame axis.
        """
        lefts = jax.device_put(jnp.asarray(lefts), self._shard)
        rights = jax.device_put(jnp.asarray(rights), self._shard)
        if self._chunk is None:
            step = self._raw_step

            def chunk(states, ls, rs):
                # scan wants the frame axis leading: [B,N,H,W] -> [N,B,H,W]
                return jax.lax.scan(
                    lambda s, lr: jax.vmap(step)(s, lr[0], lr[1]),
                    states,
                    (jnp.swapaxes(ls, 0, 1), jnp.swapaxes(rs, 0, 1)))

            self._chunk = jax.jit(self._per_device(chunk, (P("seq"),
                                                           P(None, "seq"))))
        self.states, results = self._chunk(self.states, lefts, rights)
        return results
