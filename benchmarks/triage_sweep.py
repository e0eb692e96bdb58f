"""Measure the (triage_iters, cap_frac) tradeoff across operating points.

VERDICT round-1 flagged that the two-phase straggler triage default was
tuned at the headline bench point only, and that at high-FER operating
points the fast pass is pure overhead (every batch overflows the straggler
buffer and falls back to a full-batch decode).  This harness measures
decoded throughput for triage settings x SNR points with the honest
methodology (fresh on-device noise per timed call, scalar outputs, grouped
dispatch) and records everything to results.jsonl so defaults are chosen
from data.

Usage::

    python benchmarks/triage_sweep.py            # wimax + wifi sweeps
"""
from __future__ import annotations

import json
import os
import sys
import time

import numpy as np

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

RESULTS = os.path.join(os.path.dirname(os.path.abspath(__file__)), "results.jsonl")


def sweep(code, enc_bits, snrs, batch, group, triage_settings, base_cfg):
    import dataclasses

    import jax
    import jax.numpy as jnp

    from myldpccppapi import Decoder

    rng = np.random.default_rng(0)
    u = rng.integers(0, 2, size=(batch, code.k), dtype=np.uint8)
    cw = enc_bits(u)
    sym_dev = jax.device_put(jnp.asarray(1.0 - 2.0 * cw.astype(np.float32)))
    rows = []
    for (ti, cap) in triage_settings:
        cfg = dataclasses.replace(base_cfg, triage_iters=ti,
                                  triage_cap_frac=cap)
        dec = Decoder(code, cfg)

        @jax.jit
        def run(llr_g):
            def one(llr):
                res = dec(llr)
                return (jnp.sum(res.iterations),
                        jnp.sum(jnp.where(res.converged, 1, 0)))
            outs = jax.lax.map(one, llr_g)
            return tuple(jnp.sum(o) for o in outs)

        for snr_db in snrs:
            sigma = 10 ** (-snr_db / 20)

            @jax.jit
            def make_llr(key):
                noise = sigma * jax.random.normal(key, sym_dev.shape)
                return 2.0 * (sym_dev + noise) / (sigma * sigma)

            groups = [
                jnp.stack([make_llr(jax.random.PRNGKey(31 * gi + i))
                           for i in range(group)])
                for gi in range(3)
            ]
            jax.block_until_ready(groups)
            out = run(groups[0])
            jax.block_until_ready(out)
            times = []
            for g in groups:
                t0 = time.perf_counter()
                out = run(g)
                jax.block_until_ready(out)
                times.append(time.perf_counter() - t0)
            dt = sorted(times)[1]
            frames = group * batch
            iters_sum, conv_sum = (int(x) for x in out)
            row = {
                "code": code.name, "snr_db": snr_db,
                "triage_iters": ti, "cap_frac": cap,
                "throughput_mbits": round(frames * code.k / dt / 1e6, 1),
                "conv_rate": round(conv_sum / frames, 4),
                "mean_iters": round(iters_sum / frames, 2),
            }
            rows.append(row)
            print(json.dumps(row), flush=True)
    return rows


def main():
    import jax.numpy as jnp

    from myldpccppapi import DecoderConfig, Encoder, wifi, wimax
    from myldpccppapi.codes import encode_numpy

    settings = [(0, 0.125), (3, 0.125), (5, 0.125), (8, 0.125), (5, 0.25)]
    all_rows = []

    code = wimax(576, "3/4B")
    enc = Encoder(code)
    all_rows += sweep(
        code, lambda u: encode_numpy(enc.mats, u),
        snrs=[3.5, 4.0, 4.5, 5.0], batch=8192, group=8,
        triage_settings=settings,
        base_cfg=DecoderConfig(schedule="layered", normalization=0.75,
                               max_iters=40),
    )

    code2 = wifi(1944, "5/6")
    enc2 = Encoder(code2)
    all_rows += sweep(
        code2, lambda u: encode_numpy(enc2.mats, u),
        snrs=[5.5, 6.0, 6.5], batch=4096, group=4,
        triage_settings=settings,
        base_cfg=DecoderConfig(schedule="layered", normalization=0.75,
                               max_iters=40),
    )

    with open(RESULTS, "a") as f:
        f.write(json.dumps({"config": "triage_sweep", "rows": all_rows}) + "\n")


if __name__ == "__main__":
    main()
