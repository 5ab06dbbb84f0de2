"""Multi-host execution without a cluster (SURVEY.md §4 item 5, §2.3
"Communication backend" row): two REAL OS processes, each owning two
virtual CPU devices, joined by `jax.distributed.initialize` (Gloo
collectives), must reproduce the 1-process 4-device fp64 trajectory of
the partitioned trainer bit-exactly — the program is the same SPMD
computation either way; only the process→device mapping changes.

Workers run in subprocesses (tests/mp_worker.py) because platform and
device-count flags must be set before jax's backend initializes, and
this pytest process already holds an 8-device CPU backend.
"""

import os
import socket
import subprocess
import sys

import numpy as np

_WORKER = os.path.join(os.path.dirname(__file__), "mp_worker.py")


def _free_port() -> int:
    with socket.socket() as s:
        s.bind(("localhost", 0))
        return s.getsockname()[1]


def _env():
    env = dict(os.environ)
    env.pop("XLA_FLAGS", None)  # worker sets its own device count
    env["JAX_PLATFORMS"] = "cpu"
    return env


def _run(extra, timeout=420):
    return subprocess.run(
        [sys.executable, _WORKER] + extra,
        env=_env(), capture_output=True, text=True, timeout=timeout,
    )


def test_two_process_trajectory_matches_single(tmp_path):
    single = tmp_path / "single.npz"
    multi = tmp_path / "multi.npz"

    r = _run(["--out", str(single), "--devices", "4"])
    assert r.returncode == 0, f"single-process worker failed:\n{r.stderr[-3000:]}"

    port = _free_port()
    procs = [
        subprocess.Popen(
            [
                sys.executable, _WORKER,
                "--out", str(multi), "--devices", "2",
                "--coordinator", f"localhost:{port}",
                "--nproc", "2", "--pid", str(pid),
            ],
            env=_env(), stdout=subprocess.PIPE, stderr=subprocess.PIPE,
            text=True,
        )
        for pid in range(2)
    ]
    outs = [p.communicate(timeout=420) for p in procs]
    for p, (out, err) in zip(procs, outs):
        assert p.returncode == 0, f"rank failed:\n{err[-3000:]}"

    a = np.load(single)
    b = np.load(multi)
    assert set(a.files) == set(b.files)
    for k in a.files:
        if k == "loss":
            # the scalar loss metric crosses a psum whose cross-process
            # (Gloo) reduction order may differ from the single-process
            # one by a final-ulp reassociation; parameters must still be
            # bit-exact (and are — their reductions are per-row scatter
            # adds with a fixed order).
            np.testing.assert_allclose(a[k], b[k], rtol=1e-14)
        else:
            np.testing.assert_array_equal(
                a[k], b[k],
                err_msg=f"{k} diverged between 1- and 2-process runs",
            )


def test_multiprocess_sharded_checkpoint_equals_single(tmp_path):
    """Each rank writes only its own shards; the resulting directory must
    load (in THIS single process, onto a 4-device mesh) bit-identical to
    the one written by the 1-process run."""
    single = tmp_path / "single.npz"
    multi = tmp_path / "multi.npz"

    r = _run(["--out", str(single), "--devices", "4"])
    assert r.returncode == 0, r.stderr[-2000:]
    port = _free_port()
    procs = [
        subprocess.Popen(
            [
                sys.executable, _WORKER,
                "--out", str(multi), "--devices", "2",
                "--coordinator", f"localhost:{port}",
                "--nproc", "2", "--pid", str(pid),
            ],
            env=_env(), stdout=subprocess.PIPE, stderr=subprocess.PIPE,
            text=True,
        )
        for pid in range(2)
    ]
    for p in procs:
        _, err = p.communicate(timeout=420)
        assert p.returncode == 0, err[-2000:]

    import jax

    from skge_tpu.parallel.partitioned import make_shard_mesh
    from skge_tpu.utils.checkpoint import load_sharded_checkpoint

    mesh = make_shard_mesh(jax.devices()[:4])
    a, meta_a = load_sharded_checkpoint(str(single) + ".ckpt", mesh)
    b, meta_b = load_sharded_checkpoint(str(multi) + ".ckpt", mesh)
    assert meta_a["n_entities"] == meta_b["n_entities"]
    # the loss metric crosses a psum whose cross-process reduction order
    # differs by a final ulp (see the trajectory test above)
    for ma, mb in zip(meta_a["metrics"], meta_b["metrics"]):
        assert ma["nviolations"] == mb["nviolations"]
        np.testing.assert_allclose(ma["loss"], mb["loss"], rtol=1e-14)
    flat_a = jax.tree.leaves(a.params) + jax.tree.leaves(a.opt_state)
    flat_b = jax.tree.leaves(b.params) + jax.tree.leaves(b.opt_state)
    for x, y in zip(flat_a, flat_b):
        np.testing.assert_array_equal(
            np.asarray(jax.device_get(x)), np.asarray(jax.device_get(y))
        )


def test_launcher_spawns_env_driven_gang(tmp_path):
    """scripts/launch_distributed.py wires SKGE_* env vars; the worker's
    bare `distributed.initialize()` picks them up and the 2-rank result
    matches the 1-process 4-device run."""
    single = tmp_path / "single.npz"
    multi = tmp_path / "multi.npz"
    r = _run(["--out", str(single), "--devices", "4"])
    assert r.returncode == 0, r.stderr[-2000:]

    launcher = os.path.join(
        os.path.dirname(os.path.dirname(os.path.abspath(__file__))),
        "scripts", "launch_distributed.py",
    )
    r = subprocess.run(
        [
            sys.executable, launcher, "--nproc", "2",
            "--devices-per-proc", "2", "--",
            sys.executable, _WORKER, "--out", str(multi), "--devices", "2",
        ],
        env=_env(), capture_output=True, text=True, timeout=420,
    )
    assert r.returncode == 0, r.stderr[-2000:]
    a, b = np.load(single), np.load(multi)
    for k in a.files:
        if k == "loss":
            np.testing.assert_allclose(a[k], b[k], rtol=1e-14)
        else:
            np.testing.assert_array_equal(a[k], b[k], err_msg=k)
