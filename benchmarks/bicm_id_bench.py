"""BICM-ID measured on chip: FER gain vs outer exchanges + throughput cost.

Two cases, deliberately contrasting:

* **non-Gray 8PSK** (natural-binary ring labels) + wimax 576 r1/2 — the
  constellation class iterative demapping exists for: neighboring points
  differ in several bits, so decoder feedback resolves real demapper
  ambiguity.  Expect a visible FER drop per exchange.
* **shipped quasi-Gray 16APSK** + DVB-S2 16200 r3/4 — the standard's
  operating regime.  Expected ~flat (Gray-ish labelings have a flat
  demapper EXIT curve); MEASURED a real win — the quasi-Gray ring
  labeling keeps enough non-Gray neighbor edges (and 16APSK's inner
  ring packs 4 points closely) that feedback pays: FER 0.42 -> 0/8192
  at 13.9 dB with two exchanges (2026-08-20 record).  The prediction
  was wrong; the measurement stands.

Methodology: fixed SNR points near each one-shot cliff, same pre-staged
noisy symbol batches decoded by every receiver variant (paired
comparison — differences are decoder-only, not noise), frame errors
counted on device.  Throughput: two-depth pipelined fit per variant
(BENCH_NOTES round-3 methodology).

Usage::

    python benchmarks/bicm_id_bench.py          # both cases + throughput
"""
from __future__ import annotations

import json
import os
import sys
import time

import numpy as np

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))

from run_baseline import _emit  # shared emitter (single results.jsonl format)


def _modulate_np(bits: np.ndarray, mod) -> np.ndarray:
    """Host-side mapper (numpy): same bit->symbol convention as modulate."""
    m = mod.bits_per_symbol
    b = bits.reshape(bits.shape[:-1] + (-1, m)).astype(np.int64)
    idx = (b << np.arange(m)).sum(axis=-1)
    return np.asarray(mod.lut())[idx]


def run_case(name, code, enc_fn, mod, cfg, snr_points, n_outers,
             batch, rounds, method="maxlog", extrinsic_scale=1.0,
             budget_control=True):
    """``budget_control`` adds a one-shot receiver whose iteration budget
    equals the LARGEST ID variant's total ((max n_outer + 1) x max_iters),
    keyed "ctl" in the emitted rows — without it, comparing n_outer=k
    against the plain one-shot conflates demapper feedback with k extra
    decoder budgets (review finding, round 5)."""
    import dataclasses

    import jax
    import jax.numpy as jnp

    from myldpccppapi.ops.bicm_id import make_bicm_id_receive

    rng = np.random.default_rng(0)
    u = rng.integers(0, 2, size=(batch, code.k), dtype=np.uint8)
    cw = np.asarray(enc_fn(jnp.asarray(u)))
    u_dev = jnp.asarray(u, jnp.int8)
    pos = jnp.asarray(code.info_positions)
    # stage f32 I/Q planes, form the complex view inside the jitted
    # programs
    tx_np = _modulate_np(cw, mod)
    tx_i = jax.device_put(jnp.asarray(tx_np.real.astype(np.float32)))
    tx_q = jax.device_put(jnp.asarray(tx_np.imag.astype(np.float32)))

    receivers = {n: make_bicm_id_receive(code, cfg, mod, n_outer=n,
                                         method=method,
                                         extrinsic_scale=extrinsic_scale)
                 for n in n_outers}
    if budget_control:
        cfg_ctl = dataclasses.replace(
            cfg, max_iters=(max(n_outers) + 1) * cfg.max_iters)
        receivers["ctl"] = make_bicm_id_receive(code, cfg_ctl, mod,
                                                n_outer=0, method=method)

    rows = []
    for snr_db in snr_points:
        # per-component sigma from Es/sigma_c^2 (same convention as 3m/4m)
        sigma = 10 ** (-snr_db / 20)
        n0 = 2.0 * sigma * sigma

        @jax.jit
        def make_y(key):
            noise = jax.random.normal(key, tx_i.shape + (2,), jnp.float32)
            tx = jax.lax.complex(tx_i, tx_q)
            return tx + sigma * jax.lax.complex(noise[..., 0], noise[..., 1])

        counters = {}
        for n, rx in receivers.items():
            @jax.jit
            def one(y, rx=rx):
                res = rx(y, n0)
                ferr = (res.bits[:, pos].astype(jnp.int8) != u_dev
                        ).any(axis=1)
                return jnp.stack([
                    jnp.sum(jnp.where(ferr, 1, 0)),
                    jnp.sum(jnp.where(res.converged, 1, 0)),
                    jnp.sum(res.iterations),
                ])
            counters[n] = one

        # paired: every receiver sees the SAME noisy batches
        keys = list(receivers)
        agg = {n: np.zeros(3, np.int64) for n in keys}
        for r in range(rounds):
            y = make_y(jax.random.PRNGKey(5000 + 100 * int(snr_db * 10) + r))
            jax.block_until_ready(y)
            outs = {n: counters[n](y) for n in keys}
            stacked = np.asarray(jnp.stack([outs[n] for n in keys]))
            for i, n in enumerate(keys):
                agg[n] += stacked[i].astype(np.int64)
        frames = rounds * batch
        row = {"snr_db": snr_db, "frames": frames}
        for n in keys:
            fe, cv, it = (int(x) for x in agg[n])
            row[f"outer{n}"] = {
                "fer": round(fe / frames, 6), "frame_errors": fe,
                "conv": round(cv / frames, 4),
                "mean_iters": round(it / frames, 2),
            }
        rows.append(row)
        print(f"[bicm_id] {name} @{snr_db} dB: " + " ".join(
            f"o{n}={row[f'outer{n}']['fer']:.2e}" for n in keys),
            file=sys.stderr, flush=True)
    return rows


def throughput(name, code, enc_fn, mod, cfg, snr_db, n_outers, batch,
               n_pipe=16, method="maxlog"):
    """Two-depth fit per receiver variant: the marginal cost of each
    extra demap<->decode exchange."""
    import jax
    import jax.numpy as jnp

    from myldpccppapi.ops.bicm_id import make_bicm_id_receive

    from run_baseline import _depth_fit, _fit_record, _pipe_rounds

    rng = np.random.default_rng(0)
    u = rng.integers(0, 2, size=(batch, code.k), dtype=np.uint8)
    cw = np.asarray(enc_fn(jnp.asarray(u)))
    tx_np = _modulate_np(cw, mod)
    tx_i = jax.device_put(jnp.asarray(tx_np.real.astype(np.float32)))
    tx_q = jax.device_put(jnp.asarray(tx_np.imag.astype(np.float32)))
    sigma = 10 ** (-snr_db / 20)
    n0 = 2.0 * sigma * sigma

    @jax.jit
    def make_y(key):
        noise = jax.random.normal(key, tx_i.shape + (2,), jnp.float32)
        tx = jax.lax.complex(tx_i, tx_q)
        return tx + sigma * jax.lax.complex(noise[..., 0], noise[..., 1])

    rows = []
    for n in n_outers:
        rx = make_bicm_id_receive(code, cfg, mod, n_outer=n, method=method)

        @jax.jit
        def one(y, rx=rx):
            res = rx(y, n0)
            return jnp.stack([jnp.sum(res.iterations),
                              jnp.sum(jnp.where(res.converged, 1, 0))])

        make_input = lambda i: make_y(jax.random.PRNGKey(9000 + 37 * n + i))
        dt, agg = _pipe_rounds(one, make_input, n_pipe)
        dt_lo, n_lo = _depth_fit(one, make_input, n_pipe)
        frames = n_pipe * batch
        rows.append({
            "n_outer": n,
            "throughput_mbits": round(frames * code.k / dt / 1e6, 3),
            "fit": _fit_record(dt, n_pipe, dt_lo, n_lo, batch * code.k),
            "conv": round(int(agg[1]) / frames, 4),
            "mean_iters": round(int(agg[0]) / frames, 2),
        })
    return rows


def main():
    import jax.numpy as jnp

    from myldpccppapi import DecoderConfig, Encoder
    from myldpccppapi.codes import wimax
    from myldpccppapi.codes.dvbs2 import dvbs2, ira_encode_fn
    from myldpccppapi.ops.modulation import (Modulation, _bits_of,
                                                 make_modulation)

    # case 1: non-Gray 8PSK, wimax 576 r1/2
    code1 = wimax(576, "1/2")
    enc1 = Encoder(code1)
    natural = Modulation(
        "8psk_nat",
        np.exp(1j * (2 * np.pi * np.arange(8) / 8 + np.pi / 8)
               ).astype(np.complex64),
        _bits_of(np.arange(8), 3),
    )
    cfg1 = DecoderConfig(schedule="layered", normalization=0.75,
                         max_iters=30)
    rows = run_case("8psk_natural_wimax576", code1, enc1, natural, cfg1,
                    snr_points=[9.0, 9.5, 10.0, 10.5, 11.0],
                    n_outers=[0, 1, 2, 3], batch=2048, rounds=8)
    _emit({"config": "bicm_id", "name": "bicm_id_8psk_natural_wimax576_r12",
           "labeling": "natural (non-Gray)", "sweep": rows})

    # case 2: shipped quasi-Gray 16APSK, DVB-S2 16200 r3/4 (standard regime)
    code2 = dvbs2(16200, "3/4")
    enc2fn = ira_encode_fn(code2)
    mod2 = make_modulation("16apsk", "3/4")
    cfg2 = DecoderConfig(schedule="layered", normalization=0.85,
                         max_iters=30)
    rows2 = run_case("16apsk_dvbs2_16200_r34", code2, enc2fn, mod2, cfg2,
                     snr_points=[13.9, 14.1, 14.3], n_outers=[0, 2],
                     batch=1024, rounds=8)
    _emit({"config": "bicm_id", "name": "bicm_id_16apsk_dvbs2_16200_r34",
           "labeling": "quasi-Gray (shipped)", "sweep": rows2})

    # throughput cost per exchange (case-1 shape at its clean point)
    t_rows = throughput("8psk_natural_wimax576", code1, enc1, natural,
                        cfg1, snr_db=12.0, n_outers=[0, 1, 2], batch=2048)
    _emit({"config": "bicm_id_tp",
           "name": "bicm_id_throughput_8psk_wimax576", "rows": t_rows})

    # long-code throughput: the feedback passes' soft output runs on the
    # jnp path
    t2 = throughput("16apsk_dvbs2_16200_r34", code2, enc2fn, mod2, cfg2,
                    snr_db=14.5, n_outers=[0, 1, 2], batch=1024)
    _emit({"config": "bicm_id_tp",
           "name": "bicm_id_throughput_16apsk_dvbs2_16200_r34",
           "rows": t2})


if __name__ == "__main__":
    main()
