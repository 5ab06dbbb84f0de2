"""chip_smoke.py's helpers and phases, on the CPU: the device check, the
last-line format, the comparators, the compile-cache location, and every
phase end to end at a tiny size with CPU devices standing in for the card."""

import importlib.util
import json
import os
import subprocess
import sys
from types import SimpleNamespace

import numpy as np
import pytest

import jax

from skge_tpu.training import TrainState
from skge_tpu.utils import compile_cache

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def _load(relpath, name):
    spec = importlib.util.spec_from_file_location(
        name, os.path.join(ROOT, relpath))
    mod = importlib.util.module_from_spec(spec)
    sys.modules[name] = mod  # dataclasses look their module up here
    spec.loader.exec_module(mod)
    return mod


cs = _load("chip_smoke.py", "chip_smoke")
launch = _load(os.path.join("scripts", "launch_distributed.py"),
               "launch_distributed")

TINY = cs.Shape(entities=61, relations=5, train=600, test=20, queries=16,
                nbatches=4, k=16, d=8, rescal_d=6, negatives=2)


def test_check_backend_refuses_cpu():
    with pytest.raises(SystemExit, match="not 'gpu'"):
        cs.check_backend("cpu")
    cs.check_backend("gpu")


def test_main_without_gpu_fails_and_prints_no_result(capsys):
    with pytest.raises(SystemExit):
        cs.main([])
    assert '"ok"' not in capsys.readouterr().out


@pytest.mark.parametrize("count", [1, 4])
def test_result_line_format(count):
    dev = SimpleNamespace(platform="gpu", device_kind="NVIDIA H100 80GB HBM3")
    line = cs.result_line([dev] * count)
    assert json.loads(line) == {"ok": True, "device": {
        "platform": "gpu", "kind": "NVIDIA H100 80GB HBM3", "count": count}}
    assert "\n" not in line


def test_check_close_tolerance_and_skip():
    want = np.array([1.0, 2.0, 3.0])
    assert cs.check_close("x", want + 5e-6, want, 1e-5, 0.0) == pytest.approx(
        5e-6)
    with pytest.raises(AssertionError, match="1 of 3"):
        cs.check_close("x", want + [0, 0, 1e-3], want, 1e-5, 1e-5)
    skip = np.array([False, False, True])
    cs.check_close("x", want + [0, 0, 1e-3], want, 1e-5, 1e-5, skip=skip)


def _state(param, grad):
    p = {"E": np.asarray(param, np.float64)}
    o = {"E": {"p2": np.asarray(grad, np.float64) ** 2}}
    return TrainState(p, o, None, None)


def test_check_step_holds_flat_coordinates_to_the_step_reach():
    """AdaGrad amplifies rounding where |g| < 1e-6, so such coordinates
    are held to 2*lr; elsewhere ATOL/RTOL holds."""
    want = (_state([0.5, 0.2], [0.3, 2e-7]), 7)
    got = (_state([0.5, 0.2 + 1e-3], [0.3, 2.1e-7]), 7)
    d = cs.check_step("flat", got, want)
    assert d["n_flat"] == 1 and d["worst"] == 0.0
    with pytest.raises(AssertionError):
        cs.check_step("steep", (_state([0.5 + 1e-3, 0.2], [0.3, 2e-7]), 7),
                      want)
    with pytest.raises(AssertionError, match="violations"):
        cs.check_step("viol", (want[0], 8), want)


def test_check_topk_allows_swapped_ties():
    want = SimpleNamespace(entities=np.array([[3, 4, 5]]),
                           scores=np.array([[-1.0, -2.0, -2.0]]))
    got = SimpleNamespace(entities=np.array([[3, 5, 4]]),
                          scores=np.array([[-1.0, -2.0, -2.0 + 1e-6]]))
    assert cs.check_topk("t", got, want)["positions_swapped"] == 2
    got.scores = np.array([[-1.0, -1.5, -2.0]])
    with pytest.raises(AssertionError):
        cs.check_topk("t", got, want)


def test_compile_cache_dir_follows_env(monkeypatch):
    monkeypatch.setenv(compile_cache.ENV_VAR, "/elsewhere/cache")
    calls = []
    monkeypatch.setattr(compile_cache.jax.config, "update",
                        lambda *a: calls.append(a))
    assert compile_cache.enable_compile_cache() == "/elsewhere/cache"
    assert calls == []  # JAX's own setting is left alone


def test_compile_cache_default_is_fixed_in_checkout(monkeypatch):
    monkeypatch.delenv(compile_cache.ENV_VAR, raising=False)
    calls = []
    monkeypatch.setattr(compile_cache.jax.config, "update",
                        lambda *a: calls.append(a))
    first = compile_cache.enable_compile_cache()
    assert first == compile_cache.enable_compile_cache()
    assert first == os.path.join(ROOT, ".jax_cache")
    assert calls == [("jax_compilation_cache_dir", first)] * 2


def test_single_card_phases_on_cpu():
    cpu = jax.devices("cpu")
    ds = cs.make_dataset(TINY)
    model, params = cs.phase_train(TINY, ds, cpu[0])
    out = cs.phase_compare(TINY, ds, cpu[1], cpu[0])
    assert set(out) == {"flagship", "iid", "rescal"}
    assert cs.phase_evaluate(model, params, ds, cpu[1], cpu[0])["dmrr"] == 0
    cs.phase_serve(TINY, model, params, ds, cpu[1], cpu[0])


def test_multi_card_phases_on_cpu():
    devices = jax.devices("cpu")[:4]
    ds = cs.make_dataset(TINY)
    cs.phase_mesh_step(TINY, ds, devices)
    worst, d = cs.phase_partitioned(TINY, ds, devices)
    assert worst == 0.0 and d["same"] == 1.0


def test_launcher_gives_each_rank_one_gpu():
    envs = [launch.rank_env({"PATH": "/bin"}, r, 2, 1234, 0, ["4", "6"])
            for r in range(2)]
    assert [e["CUDA_VISIBLE_DEVICES"] for e in envs] == ["4", "6"]
    assert [e["SKGE_PROCESS_ID"] for e in envs] == ["0", "1"]
    assert all(e["SKGE_COORDINATOR"] == "localhost:1234" for e in envs)
    assert all("JAX_PLATFORMS" not in e for e in envs)


def test_launcher_virtual_cpu_devices():
    env = launch.rank_env({}, 1, 2, 99, 3, [])
    assert env["JAX_PLATFORMS"] == "cpu"
    assert env["XLA_FLAGS"] == "--xla_force_host_platform_device_count=3"
    assert "CUDA_VISIBLE_DEVICES" not in env


def test_launcher_refuses_more_ranks_than_gpus():
    env = dict(os.environ, CUDA_VISIBLE_DEVICES="0,1")
    r = subprocess.run(
        [sys.executable, os.path.join(ROOT, "scripts", "launch_distributed.py"),
         "--nproc", "3", "--", sys.executable, "-c", "pass"],
        env=env, capture_output=True, text=True, timeout=60)
    assert r.returncode == 2
    assert "exceeds the 2 visible GPUs" in r.stderr


def test_distributed_initialize_stays_single_host(monkeypatch):
    from skge_tpu.parallel import distributed as dist

    for var in ("SKGE_COORDINATOR", "SKGE_NUM_PROCESSES", "SKGE_PROCESS_ID"):
        monkeypatch.delenv(var, raising=False)
    monkeypatch.setattr(dist, "_initialized", False)

    def boom(**kw):
        raise AssertionError("jax.distributed.initialize must not run")

    monkeypatch.setattr(dist.jax.distributed, "initialize", boom)
    assert dist.initialize() is False
