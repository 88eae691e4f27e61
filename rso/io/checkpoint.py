"""Engine-state checkpoint/resume: exact, whole-pytree.

JAX equivalent of the reference's saveStateToFile/loadStateFromFile
(stereo_vo common.cpp:261-350, :475-543).  Where the reference hand-serializes
keypoint/match structs (and only round-trips the legacy single-octave ORB
fields, h:767-768), this checkpoints the *entire* EngineState pytree to NPZ —
resume is bit-exact for every configuration.
"""
from __future__ import annotations

import numpy as np
import jax

from rso.engine import EngineState, init_state
from rso.config import RSOConfig


def save_state(path: str, state: EngineState) -> None:
    leaves, treedef = jax.tree_util.tree_flatten(state)
    arrays = {f"leaf_{i}": np.asarray(x) for i, x in enumerate(leaves)}
    np.savez_compressed(path, n_leaves=len(leaves), **arrays)


def load_state(path: str, cfg: RSOConfig,
               img_hw: tuple | None = None) -> EngineState:
    """Rebuild the pytree using a template from the config (shapes must match
    the config the state was saved under).  img_hw is required for
    OPTICAL_FLOW-mode states (they carry the prev pyramids)."""
    data = np.load(path)
    template = init_state(cfg, img_hw)
    leaves, treedef = jax.tree_util.tree_flatten(template)
    n = int(data["n_leaves"])
    if n != len(leaves):
        raise ValueError(
            f"checkpoint has {n} leaves but config implies {len(leaves)} "
            "(different nOctaves / capacities?)")
    new_leaves = []
    for i, tmpl in enumerate(leaves):
        arr = data[f"leaf_{i}"]
        if arr.shape != tuple(np.shape(tmpl)):
            raise ValueError(f"leaf {i} shape {arr.shape} != {np.shape(tmpl)}")
        new_leaves.append(arr.astype(np.asarray(tmpl).dtype))
    return jax.tree_util.tree_unflatten(treedef, new_leaves)
