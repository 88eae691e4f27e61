"""True multi-process distributed-BA test: two OS processes, each owning one
CPU device, joined via jax.distributed — the closest single-machine analogue
of a 2-host pod run (SURVEY.md section 4's multi-host test strategy).

Each process runs the SAME distributed_bundle_adjust over the global 2-device
mesh; process 0 writes its result, and the test compares it against the
single-process solver.
"""
import json
import os
import socket
import subprocess
import sys

import numpy as np
import pytest

_WORKER = r"""
import json, os, sys
os.environ["JAX_PLATFORMS"] = "cpu"
os.environ["XLA_FLAGS"] = "--xla_force_host_platform_device_count=1"
import jax
jax.distributed.initialize(
    coordinator_address=sys.argv[1],
    num_processes=2,
    process_id=int(sys.argv[2]),
)
import jax.numpy as jnp
import numpy as np
from scipy.spatial.transform import Rotation

sys.path.insert(0, sys.argv[4])
from rso.ba import BAProblem, distributed_bundle_adjust
from rso.ba.ba import _project_grid
from rso.ba.multihost import global_landmark_mesh
from rso.geometry.stereo_camera import StereoCamera

assert jax.process_count() == 2
assert len(jax.devices()) == 2  # global devices across both processes

CAM = StereoCamera.make(fx_l=500.0, fy_l=500.0, cx_l=320.0, cy_l=240.0,
                        baseline=0.5)
rng = np.random.default_rng(7)
P, L = 4, 64
true_poses = []
for p in range(P):
    T_wc = np.array([0.01 * p, -0.005 * p, 0.4 * p])
    w = np.array([0.0, 0.002 * p, 0.0])
    R = Rotation.from_rotvec(w).as_matrix()
    Rwc = R.T
    t = -Rwc @ T_wc
    true_poses.append(np.concatenate([Rotation.from_matrix(Rwc).as_rotvec(), t]))
true_poses = jnp.asarray(np.stack(true_poses), jnp.float32)
lmks_true = jnp.asarray(np.stack([
    rng.uniform(-8, 8, L), rng.uniform(-4, 4, L), rng.uniform(5, 30, L)], -1),
    jnp.float32)
pix, _, _ = _project_grid(CAM, true_poses, lmks_true)
obs = pix + jnp.asarray(rng.normal(0, 0.2, pix.shape), jnp.float32)
prob = BAProblem(
    poses=(true_poses + 0.01).at[0].set(true_poses[0]),
    lmks=lmks_true + 0.05,
    obs=obs,
    mask=jnp.ones((P, L), bool),
)
mesh = global_landmark_mesh()
assert mesh.devices.size == 2
res = distributed_bundle_adjust(CAM, prob, mesh, max_iters=10)
# out_specs are fully replicated, so every process holds the whole answer
poses = np.asarray(jax.device_get(res.poses))
if jax.process_index() == 0:
    with open(sys.argv[3], "w") as f:
        json.dump({"poses": poses.tolist()}, f)
jax.distributed.shutdown()
"""


_WORKER_WINSHARD = r"""
import json, os, sys
os.environ["JAX_PLATFORMS"] = "cpu"
os.environ["XLA_FLAGS"] = "--xla_force_host_platform_device_count=1"
import jax
NPROC = int(sys.argv[5]) if len(sys.argv) > 5 else 2
jax.distributed.initialize(
    coordinator_address=sys.argv[1],
    num_processes=NPROC,
    process_id=int(sys.argv[2]),
)
import jax.numpy as jnp
import numpy as np
from scipy.spatial.transform import Rotation

sys.path.insert(0, sys.argv[4])
from rso.ba import BAProblem, window_sharded_bundle_adjust
from rso.ba.ba import _project_grid
from rso.ba.window_sharded import make_win_mesh
from rso.geometry.stereo_camera import StereoCamera

assert jax.process_count() == NPROC
assert len(jax.devices()) == NPROC

CAM = StereoCamera.make(fx_l=500.0, fy_l=500.0, cx_l=320.0, cy_l=240.0,
                        baseline=0.5)

def make_problem(seed, P=4, L=64):
    rng = np.random.default_rng(seed)
    true_poses = []
    for p in range(P):
        T_wc = np.array([0.01 * p, -0.005 * p, 0.4 * p])
        w = np.array([0.0, 0.002 * p, 0.0])
        Rwc = Rotation.from_rotvec(w).as_matrix().T
        t = -Rwc @ T_wc
        true_poses.append(np.concatenate([
            Rotation.from_matrix(Rwc).as_rotvec(), t]))
    true_poses = jnp.asarray(np.stack(true_poses), jnp.float32)
    lmks_true = jnp.asarray(np.stack([
        rng.uniform(-8, 8, L), rng.uniform(-4, 4, L),
        rng.uniform(5, 30, L)], -1), jnp.float32)
    pix, _, _ = _project_grid(CAM, true_poses, lmks_true)
    obs = pix + jnp.asarray(rng.normal(0, 0.2, pix.shape), jnp.float32)
    return BAProblem(poses=(true_poses + 0.01).at[0].set(true_poses[0]),
                     lmks=lmks_true + 0.05, obs=obs,
                     mask=jnp.ones((P, L), bool))

probs = [make_problem(s) for s in range(NPROC)]
# one window per HOST: win axis spans the processes, lmk axis is 1 —
# no cross-host traffic inside the LM loop
mesh = make_win_mesh(NPROC, 1, devices=jax.devices())
outs = window_sharded_bundle_adjust(CAM, probs, mesh, max_iters=10)
poses = [np.asarray(jax.device_get(o.poses)).tolist() for o in outs]
if jax.process_index() == 0:
    with open(sys.argv[3], "w") as f:
        json.dump({"poses": poses}, f)
jax.distributed.shutdown()
"""


_WORKER_DPSTEP = r"""
import json, os, sys
os.environ["JAX_PLATFORMS"] = "cpu"
os.environ["XLA_FLAGS"] = "--xla_force_host_platform_device_count=1"
import jax
jax.distributed.initialize(
    coordinator_address=sys.argv[1],
    num_processes=2,
    process_id=int(sys.argv[2]),
)
import numpy as np
import jax.numpy as jnp

sys.path.insert(0, sys.argv[4])
from rso.engine import Engine
from rso.parallel import BatchEngine
from rso.synthetic import make_sequence, synthetic_config
from jax.sharding import Mesh, NamedSharding, PartitionSpec as P

assert jax.process_count() == 2 and len(jax.devices()) == 2

H, W, N = 120, 160, 3
seqs = [make_sequence(n_frames=N, n_points=600, H=H, W=W, seed=s)
        for s in (0, 1)]
cfg = synthetic_config()
mesh = Mesh(np.array(jax.devices()), axis_names=("seq",))
be = BatchEngine(cfg, seqs[0].cam, batch=2, img_h=H, img_w=W, mesh=mesh)
batch_poses = []
for f in range(N):
    lefts = np.stack([np.asarray(s.frames[f][0]) for s in seqs])
    rights = np.stack([np.asarray(s.frames[f][1]) for s in seqs])
    res = be.process_frames(lefts, rights)
    # each process checks ITS OWN addressable shard against a local
    # single-engine run — no cross-process gather needed
    shard = [s for s in res.pose.addressable_shards][0]
    batch_poses.append(np.asarray(shard.data)[0])

pid = jax.process_index()
eng = Engine(cfg, seqs[pid].cam)
for f in range(N):
    ref = eng.process_frame(*seqs[pid].frames[f])
err = float(np.abs(np.asarray(ref.pose) - batch_poses[-1]).max())
assert err < 1e-4, f"process {pid}: DP-step pose differs from local engine by {err}"
if pid == 0:
    with open(sys.argv[3], "w") as f:
        json.dump({"ok": True, "err": err}, f)
jax.distributed.shutdown()
"""


def _run_n_process(tmp_path, worker_src, timeout=420, nproc=2):
    port = socket.socket()
    port.bind(("127.0.0.1", 0))
    addr = f"127.0.0.1:{port.getsockname()[1]}"
    port.close()

    repo = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    worker_py = tmp_path / "worker.py"
    worker_py.write_text(worker_src)
    out_json = tmp_path / "out.json"

    env = {k: v for k, v in os.environ.items()
           if not k.startswith(("JAX_", "XLA_"))}
    procs = [
        subprocess.Popen(
            [sys.executable, str(worker_py), addr, str(pid), str(out_json),
             repo, str(nproc)],
            env=env, stdout=subprocess.PIPE, stderr=subprocess.STDOUT)
        for pid in range(nproc)
    ]
    outs = [p.communicate(timeout=timeout)[0].decode() for p in procs]
    for p, o in zip(procs, outs):
        assert p.returncode == 0, f"worker failed:\n{o[-3000:]}"
    assert out_json.exists()
    return json.loads(out_json.read_text())


@pytest.mark.slow
def test_two_process_window_sharded_ba(tmp_path):
    """2 hosts x 1 device, one window per host: the window sharding must
    reproduce the single-process solver per window."""
    out = _run_n_process(tmp_path, _WORKER_WINSHARD)

    import jax.numpy as jnp
    from scipy.spatial.transform import Rotation

    from rso.ba import BAProblem, bundle_adjust
    from rso.ba.ba import _project_grid
    from rso.geometry.stereo_camera import StereoCamera

    CAM = StereoCamera.make(fx_l=500.0, fy_l=500.0, cx_l=320.0, cy_l=240.0,
                            baseline=0.5)
    for seed in range(2):
        rng = np.random.default_rng(seed)
        P_, L = 4, 64
        true_poses = []
        for p in range(P_):
            T_wc = np.array([0.01 * p, -0.005 * p, 0.4 * p])
            w = np.array([0.0, 0.002 * p, 0.0])
            Rwc = Rotation.from_rotvec(w).as_matrix().T
            t = -Rwc @ T_wc
            true_poses.append(
                np.concatenate([Rotation.from_matrix(Rwc).as_rotvec(), t]))
        true_poses = jnp.asarray(np.stack(true_poses), jnp.float32)
        lmks_true = jnp.asarray(np.stack([
            rng.uniform(-8, 8, L), rng.uniform(-4, 4, L),
            rng.uniform(5, 30, L)], -1), jnp.float32)
        pix, _, _ = _project_grid(CAM, true_poses, lmks_true)
        obs = pix + jnp.asarray(rng.normal(0, 0.2, pix.shape), jnp.float32)
        prob = BAProblem(
            poses=(true_poses + 0.01).at[0].set(true_poses[0]),
            lmks=lmks_true + 0.05, obs=obs, mask=jnp.ones((P_, L), bool))
        ref = bundle_adjust(CAM, prob, max_iters=10)
        np.testing.assert_allclose(np.asarray(out["poses"][seed]),
                                   np.asarray(ref.poses), atol=1e-3)


@pytest.mark.slow
def test_two_process_dp_step(tmp_path):
    """2-process data-parallel engine step (BatchEngine over a global 'seq'
    mesh): each process's shard must equal a local single-engine run.  The
    assertion lives in the workers; returncode 0 == pass."""
    out = _run_n_process(tmp_path, _WORKER_DPSTEP, timeout=600)
    assert out["ok"] is True


@pytest.mark.slow
def test_two_process_distributed_ba(tmp_path):
    port = socket.socket()
    port.bind(("127.0.0.1", 0))
    addr = f"127.0.0.1:{port.getsockname()[1]}"
    port.close()

    repo = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    worker_py = tmp_path / "worker.py"
    worker_py.write_text(_WORKER)
    out_json = tmp_path / "out.json"

    env = {k: v for k, v in os.environ.items()
           if not k.startswith(("JAX_", "XLA_"))}
    procs = [
        subprocess.Popen(
            [sys.executable, str(worker_py), addr, str(pid), str(out_json),
             repo],
            env=env, stdout=subprocess.PIPE, stderr=subprocess.STDOUT)
        for pid in (0, 1)
    ]
    outs = [p.communicate(timeout=420)[0].decode() for p in procs]
    for p, o in zip(procs, outs):
        assert p.returncode == 0, f"worker failed:\n{o[-3000:]}"
    assert out_json.exists()

    dist_poses = np.asarray(json.loads(out_json.read_text())["poses"])

    # single-process reference
    import jax.numpy as jnp
    from scipy.spatial.transform import Rotation

    from rso.ba import BAProblem, bundle_adjust
    from rso.ba.ba import _project_grid
    from rso.geometry.stereo_camera import StereoCamera

    CAM = StereoCamera.make(fx_l=500.0, fy_l=500.0, cx_l=320.0, cy_l=240.0,
                            baseline=0.5)
    rng = np.random.default_rng(7)
    P, L = 4, 64
    true_poses = []
    for p in range(P):
        T_wc = np.array([0.01 * p, -0.005 * p, 0.4 * p])
        w = np.array([0.0, 0.002 * p, 0.0])
        R = Rotation.from_rotvec(w).as_matrix()
        Rwc = R.T
        t = -Rwc @ T_wc
        true_poses.append(
            np.concatenate([Rotation.from_matrix(Rwc).as_rotvec(), t]))
    true_poses = jnp.asarray(np.stack(true_poses), jnp.float32)
    lmks_true = jnp.asarray(np.stack([
        rng.uniform(-8, 8, L), rng.uniform(-4, 4, L),
        rng.uniform(5, 30, L)], -1), jnp.float32)
    pix, _, _ = _project_grid(CAM, true_poses, lmks_true)
    obs = pix + jnp.asarray(rng.normal(0, 0.2, pix.shape), jnp.float32)
    prob = BAProblem(
        poses=(true_poses + 0.01).at[0].set(true_poses[0]),
        lmks=lmks_true + 0.05,
        obs=obs,
        mask=jnp.ones((P, L), bool),
    )
    ref = bundle_adjust(CAM, prob, max_iters=10)
    np.testing.assert_allclose(dist_poses, np.asarray(ref.poses), atol=1e-3)


def _winshard_ref_poses(seed):
    """Single-process bundle_adjust on the worker's make_problem(seed)."""
    import jax.numpy as jnp
    from scipy.spatial.transform import Rotation

    from rso.ba import BAProblem, bundle_adjust
    from rso.ba.ba import _project_grid
    from rso.geometry.stereo_camera import StereoCamera

    CAM = StereoCamera.make(fx_l=500.0, fy_l=500.0, cx_l=320.0, cy_l=240.0,
                            baseline=0.5)
    rng = np.random.default_rng(seed)
    P_, L = 4, 64
    true_poses = []
    for p in range(P_):
        T_wc = np.array([0.01 * p, -0.005 * p, 0.4 * p])
        w = np.array([0.0, 0.002 * p, 0.0])
        Rwc = Rotation.from_rotvec(w).as_matrix().T
        t = -Rwc @ T_wc
        true_poses.append(
            np.concatenate([Rotation.from_matrix(Rwc).as_rotvec(), t]))
    true_poses = jnp.asarray(np.stack(true_poses), jnp.float32)
    lmks_true = jnp.asarray(np.stack([
        rng.uniform(-8, 8, L), rng.uniform(-4, 4, L),
        rng.uniform(5, 30, L)], -1), jnp.float32)
    pix, _, _ = _project_grid(CAM, true_poses, lmks_true)
    obs = pix + jnp.asarray(rng.normal(0, 0.2, pix.shape), jnp.float32)
    prob = BAProblem(poses=(true_poses + 0.01).at[0].set(true_poses[0]),
                     lmks=lmks_true + 0.05, obs=obs,
                     mask=jnp.ones((P_, L), bool))
    return np.asarray(bundle_adjust(CAM, prob, max_iters=10).poses)


@pytest.mark.slow
def test_four_process_window_sharded_ba(tmp_path):
    """4 hosts x 1 device, one window per host (zero steady-state
    cross-'win' collectives).  All 4 windows must reproduce the single-process solver."""
    out = _run_n_process(tmp_path, _WORKER_WINSHARD, timeout=600, nproc=4)
    assert len(out["poses"]) == 4
    for seed in range(4):
        np.testing.assert_allclose(np.asarray(out["poses"][seed]),
                                   _winshard_ref_poses(seed), atol=1e-3)
