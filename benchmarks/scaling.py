"""Weak-scaling efficiency of the sharded decode pipeline.

BASELINE.json's third headline metric is N-host scaling efficiency >= 85%.
This harness measures weak scaling of the sharded simulation step (fixed
per-device batch, growing device count): throughput(N) / (N * throughput(1)).

The only cross-device traffic is one ``psum`` of the per-SNR counters per
step, so the efficiency measures how well the per-device decode keeps pace
as devices are added.  On a machine with several GPUs the devices are the
cards; on a virtual CPU mesh (``JAX_PLATFORMS=cpu`` with
``--xla_force_host_platform_device_count``) the "devices" share host cores,
so the efficiency there checks the harness, not the hardware.  Usage::

    python benchmarks/scaling.py [max_devices]
"""
from __future__ import annotations

import json
import os
import sys
import time

import numpy as np

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))


def measure(n_dev: int, batch_per_device: int, repeats: int = 5) -> float:
    """Decoded info Mbit/s of the sharded sim step on n_dev devices."""
    import jax
    import jax.numpy as jnp

    from myldpccppapi import DecoderConfig, wimax
    from myldpccppapi.parallel import make_mesh, make_sharded_campaign_step

    code = wimax(576, "3/4B")
    cfg = DecoderConfig(schedule="layered", normalization=0.75, max_iters=40)
    mesh = make_mesh((n_dev,), ("data",), devices=jax.devices()[:n_dev])
    step = jax.jit(make_sharded_campaign_step(
        code, cfg, mesh, batch_per_device=batch_per_device, num_snr=1
    ))
    snr = jnp.asarray([5.0], jnp.float32)
    out = step(jax.random.PRNGKey(0), snr)
    jax.block_until_ready(out.frames)
    t0 = time.perf_counter()
    for i in range(repeats):
        out = step(jax.random.PRNGKey(i), snr)
    jax.block_until_ready(out.frames)
    dt = (time.perf_counter() - t0) / repeats
    frames = int(np.asarray(out.frames)[0])
    return frames * code.k / dt / 1e6


def main() -> None:
    import jax

    max_dev = int(sys.argv[1]) if len(sys.argv) > 1 else len(jax.devices())
    dev = jax.devices()[0]
    batch_per_device = 16 if dev.platform == "cpu" else 512
    base = None
    n = 1
    while n <= max_dev:
        mbits = measure(n, batch_per_device)
        base = base or mbits
        print(json.dumps({
            "config": "scaling",
            "device": {"platform": dev.platform, "kind": dev.device_kind},
            "devices": n,
            "batch_per_device": batch_per_device,
            "throughput_mbits": round(mbits, 2),
            "efficiency": round(mbits / (n * base), 4),
        }), flush=True)
        n *= 2


if __name__ == "__main__":
    main()
