"""Entry-point plumbing: compile-cache placement, chip_smoke.py's refusal
without a GPU, and the one-device replay of the sharded campaign step."""
import os
import shutil
import subprocess
import sys

import jax
import jax.numpy as jnp
import numpy as np

from myldpccppapi.utils import runtime

_REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def test_compile_cache_defaults_to_checkout(monkeypatch):
    calls = []
    monkeypatch.delenv("JAX_COMPILATION_CACHE_DIR", raising=False)
    monkeypatch.setattr(jax.config, "update",
                        lambda name, value: calls.append((name, value)))
    path = runtime.setup_compile_cache()
    assert path == os.path.join(_REPO, ".jax_cache")
    assert calls == [("jax_compilation_cache_dir", path)]


def test_compile_cache_honours_env(monkeypatch, tmp_path):
    calls = []
    monkeypatch.setenv("JAX_COMPILATION_CACHE_DIR", str(tmp_path))
    monkeypatch.setattr(jax.config, "update",
                        lambda name, value: calls.append((name, value)))
    assert runtime.setup_compile_cache() == str(tmp_path)
    assert calls == []  # JAX reads the variable itself; nothing else is set


def _run_smoke(cwd, script):
    env = dict(os.environ, JAX_PLATFORMS="cpu")
    return subprocess.run([sys.executable, script], cwd=cwd, env=env,
                          capture_output=True, text=True, timeout=120)


def test_chip_smoke_refuses_without_gpu():
    proc = _run_smoke(_REPO, os.path.join(_REPO, "chip_smoke.py"))
    assert proc.returncode != 0
    assert "needs an NVIDIA GPU" in proc.stderr
    assert '"ok"' not in proc.stdout


def test_chip_smoke_alone_prints_no_result(tmp_path):
    shutil.copy(os.path.join(_REPO, "chip_smoke.py"), tmp_path)
    proc = _run_smoke(tmp_path, "chip_smoke.py")
    assert proc.returncode != 0
    assert '"ok"' not in proc.stdout


def test_serial_campaign_step_replays_the_mesh():
    """The sharded campaign step over a (snr=2, data=2) mesh equals its
    shard-by-shard replay on one device — the comparison chip_smoke.py
    --four makes on four cards."""
    from myldpccppapi import DecoderConfig, wimax
    from myldpccppapi.parallel import make_mesh, make_sharded_campaign_step
    from myldpccppapi.parallel.sim import serial_campaign_step

    code = wimax(576, "1/2")
    cfg = DecoderConfig(schedule="layered", max_iters=4, crc="16")
    mesh = make_mesh((2, 2), ("snr", "data"))
    snr = jnp.asarray([1.0, 2.0, 3.0, 4.0], jnp.float32)
    key = jax.random.PRNGKey(7)
    step = make_sharded_campaign_step(code, cfg, mesh, batch_per_device=8,
                                      num_snr=4, snr_axis="snr")
    sharded = jax.tree.map(np.asarray, jax.jit(step)(key, snr))
    serial = jax.tree.map(np.asarray, serial_campaign_step(
        code, cfg, key, snr, n_data=2, n_snr_shards=2, batch_per_device=8))
    for a, b in zip(sharded, serial):
        np.testing.assert_array_equal(a, b)
    assert sharded.frames.tolist() == [16] * 4
    assert sharded.frame_errors[0] > sharded.frame_errors[-1]
