"""Encoder throughput on one device, per code family.

The reference's harness times encode alongside decode (``Test.cpp:50-53``);
this records the framework's encoders' own numbers:

* 802.16e / 802.11n — batched int8 matmul against the RU-precomputed
  generator (``codes/encoder.py``)
* 5G NR BG1 — block back-substitution over the triangular base structure
  (``codes/nr.py triangular_encode_fn``)
* DVB-S2 IRA — sparse column-sum + cumulative accumulator
  (``codes/dvbs2.py encode_fn``)

Each timed dispatch encodes a distinct random info-bit batch; the output
reduces on device to a bit-sum counter (checked against the expected bit
density, which also prevents dead-code elimination).

Usage::

    python benchmarks/encode_bench.py            # all families
"""
from __future__ import annotations

import json
import os
import sys
import time

import numpy as np

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

def bench_encode(name, encode_fn, k, n, batch, n_pipe=64, rounds=3):
    """Median round time of ``n_pipe`` back-to-back encode dispatches over
    distinct random info-bit batches, each round ended by
    ``block_until_ready``."""
    import jax
    import jax.numpy as jnp

    rng = np.random.default_rng(0)

    @jax.jit
    def one(u):
        c = encode_fn(u)
        return jnp.sum(c.astype(jnp.int32))

    u0 = jax.device_put(jnp.asarray(
        rng.integers(0, 2, size=(batch, k), dtype=np.uint8)))
    jax.block_until_ready(one(u0))  # compile
    times, ones = [], []
    for _ in range(rounds):
        us = jax.block_until_ready([jax.device_put(jnp.asarray(
            rng.integers(0, 2, size=(batch, k), dtype=np.uint8)))
            for _ in range(n_pipe)])
        t0 = time.perf_counter()
        outs = jax.block_until_ready([one(u) for u in us])
        times.append(time.perf_counter() - t0)
        ones.append(int(np.sum(np.asarray(outs))))
    dt = float(np.median(times))
    frames = n_pipe * batch
    # sanity: total ones must be plausible for random data (~n/2 per frame)
    frac = ones[0] / (frames * n)
    assert 0.35 < frac < 0.65, f"{name}: encoded bit density {frac} off"
    dev = jax.devices()[0]
    print(json.dumps({
        "config": "enc", "name": name,
        "device": {"platform": dev.platform, "kind": dev.device_kind},
        "encoded_info_mbits": round(frames * k / dt / 1e6, 1),
        "round_ms": round(dt * 1e3, 3), "frames_per_round": frames,
        "dispatches": n_pipe, "batch": batch, "k": k, "n": n,
    }), flush=True)


def main():
    import jax
    import jax.numpy as jnp

    from myldpccppapi import Encoder, wifi, wimax
    from myldpccppapi.codes.dvbs2 import dvbs2_ira_qc, ira_encode_fn
    from myldpccppapi.codes.nr import nr_code, triangular_encode_fn

    wanted = sys.argv[1:] or ["wimax", "wifi", "nr", "dvbs2"]
    if "wimax" in wanted:
        code = wimax(576, "3/4B")
        enc = Encoder(code)
        bench_encode("encode_wimax576_r34B_matmul", enc, code.k, code.n,
                     batch=8192)
    if "wifi" in wanted:
        code = wifi(1944, "5/6")
        enc = Encoder(code)
        bench_encode("encode_wifi1944_r56_matmul", enc, code.k, code.n,
                     batch=4096)
    if "nr" in wanted:
        code = nr_code(z=384, bg=1)
        enc = jax.jit(triangular_encode_fn(code))
        bench_encode("encode_nr_bg1_z384_triangular", enc, code.k, code.n,
                     batch=2048)
    if "dvbs2" in wanted:
        code = dvbs2_ira_qc(64800, "1/2")
        enc = jax.jit(ira_encode_fn(code))
        bench_encode("encode_dvbs2_64800_r12_ira", enc, code.k, code.n,
                     batch=1024, n_pipe=32)


if __name__ == "__main__":
    main()
