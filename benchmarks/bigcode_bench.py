"""Long-code decode benchmarks (BASELINE configs 3 and 4) with the same
measurement discipline as bench.py: scalar on-device outputs, several
batches per dispatch, and a fresh noise realization for every timed call.

Usage: python benchmarks/bigcode_bench.py [3|4]
"""
from __future__ import annotations

import json
import os
import sys
import time

import numpy as np

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

RESULTS = os.path.join(os.path.dirname(os.path.abspath(__file__)), "results.jsonl")


def _emit(rec):
    line = json.dumps(rec)
    print(line, flush=True)
    with open(RESULTS, "a") as f:
        f.write(line + "\n")


def _measure(dec, code, u, make_llr, batch, group, repeats):
    import jax
    import jax.numpy as jnp

    u_dev = jax.device_put(jnp.asarray(u, jnp.int8))

    @jax.jit
    def run(llr_g):
        def one(llr):
            res = dec(llr)
            berr = jnp.sum(
                (res.bits[:, : code.k].astype(jnp.int8) != u_dev).astype(jnp.int32)
            )
            return berr, jnp.sum(~res.converged), jnp.sum(res.iterations)

        outs = jax.lax.map(one, llr_g)
        return tuple(jnp.sum(o) for o in outs)

    groups = []
    for _ in range(repeats + 1):
        groups.append(
            jax.device_put(jnp.asarray(np.stack([make_llr() for _ in range(group)])))
        )
    t0 = time.perf_counter()
    out = run(groups[0])
    jax.block_until_ready(out)
    compile_s = time.perf_counter() - t0
    berr, unconv, iters = (int(x) for x in out)
    times = []
    for g in groups[1:]:
        t0 = time.perf_counter()
        out = run(g)
        jax.block_until_ready(out)
        times.append(time.perf_counter() - t0)
    dt = sorted(times)[len(times) // 2]
    frames = group * batch
    return {
        "throughput_mbits": round(frames * code.k / dt / 1e6, 2),
        "dispatch_ms": round(dt * 1e3, 1),
        "frames_per_dispatch": frames,
        "conv_rate": round(1.0 - unconv / frames, 4),
        "mean_iters": round(iters / frames, 2),
        "bit_errors_bounded_by_unconverged": bool(berr <= unconv * code.k),
        "compile_warm_s": round(compile_s, 1),
        "impl": dec.implementation,
    }


def config3():
    """DVB-S2-style n=64800 r1/2 (z=360 QC form), layered NMS, batch 1024."""
    import jax.numpy as jnp

    from myldpccppapi import Decoder, DecoderConfig
    from myldpccppapi.codes import dvbs2
    from myldpccppapi.codes.dvbs2 import ira_encode_numpy

    code = dvbs2(64800, "1/2")
    rng = np.random.default_rng(0)
    batch = 1024
    u = rng.integers(0, 2, size=(batch, code.k), dtype=np.uint8)
    sym = 1.0 - 2.0 * ira_encode_numpy(code, u).astype(np.float32)
    sigma = 10 ** (-1.2 / 20)

    def make_llr():
        return (
            2.0 * (sym + rng.normal(0, sigma, sym.shape).astype(np.float32))
            / sigma**2
        )

    dec = Decoder(code, DecoderConfig(schedule="layered", normalization=0.8,
                                      max_iters=50))
    rec = _measure(dec, code, u, make_llr, batch, group=2, repeats=2)
    _emit({"config": 3, "name": "dvbs2qc_64800_r12_layered_b1024", **rec})


def config4():
    """NR-style BG1 Z=384, rate-matched (rv0 full buffer), layered NMS."""
    import jax
    import jax.numpy as jnp

    from myldpccppapi import Decoder, DecoderConfig
    from myldpccppapi.codes.nr import (
        nr_code, rate_match_bits, rate_match_llr, triangular_encode_fn,
    )

    code = nr_code(z=384, bg=1)
    rng = np.random.default_rng(0)
    batch = 512
    e = code.n - code.punctured_front
    u = rng.integers(0, 2, size=(batch, code.k), dtype=np.uint8)
    cw = np.asarray(jax.jit(triangular_encode_fn(code))(jnp.asarray(u)))
    tx = np.asarray(rate_match_bits(code, jnp.asarray(cw), e)).astype(np.float32)
    sym = 1.0 - 2.0 * tx
    snr_db = 5.0
    sigma = 10 ** (-snr_db / 20)

    def make_llr():
        y = 2.0 * (sym + rng.normal(0, sigma, sym.shape).astype(np.float32)) / sigma**2
        return np.asarray(rate_match_llr(code, jnp.asarray(y), e))

    dec = Decoder(code, DecoderConfig(schedule="layered", normalization=0.8,
                                      max_iters=30))
    rec = _measure(dec, code, u, make_llr, batch, group=8, repeats=2)
    _emit({"config": 4, "name": "nr_bg1_z384_rv0_layered_b512", "snr_db": snr_db,
           **rec})


def config2g():
    """802.11n 1944 r5/6 with grouped dispatch (chip-time throughput)."""
    import jax
    import jax.numpy as jnp

    from myldpccppapi import Decoder, DecoderConfig, Encoder, wifi
    from myldpccppapi.codes import encode_numpy
    from myldpccppapi.ops.channel import transmit

    code = wifi(1944, "5/6")
    enc = Encoder(code)
    rng = np.random.default_rng(0)
    batch = 4096
    u = rng.integers(0, 2, size=(batch, code.k), dtype=np.uint8)
    cj = jnp.asarray(encode_numpy(enc.mats, u))
    seed_it = iter(range(10_000))

    def make_llr():
        return np.asarray(
            transmit(jax.random.PRNGKey(next(seed_it)), cj, snr_db=6.5)[0],
            np.float32,
        )

    dec = Decoder(code, DecoderConfig(schedule="layered", normalization=0.75,
                                      triage_iters=4))
    rec = _measure(dec, code, u, make_llr, batch, group=8, repeats=2)
    _emit({"config": "2g", "name": "wifi1944_r56_nms_b4096_grouped", **rec})


def main():
    wanted = sys.argv[1:] or ["3", "4"]
    for c in wanted:
        {"3": config3, "4": config4, "2g": config2g}[c]()


if __name__ == "__main__":
    main()
