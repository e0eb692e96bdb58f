"""Self-corrected min-sum (SCMS, Savin 2008) error-rate experiment.

Same fixed-budget FER harness as the learned-NMS experiments
(BENCH_NOTES round 4): wimax 576 r1/2 at a 10-iteration budget, paired
noise batches, plain min-sum vs SCMS vs tuned NMS(0.75).  SCMS's pitch
is NMS-class error correction WITHOUT a tuned constant — the erasure
rule adapts per message.  SCMS runs on the jnp flooding path.
"""
from __future__ import annotations

import os
import sys

import numpy as np

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))

from run_baseline import _emit


def main():
    import jax
    import jax.numpy as jnp

    from myldpccppapi import Decoder, DecoderConfig, Encoder, wimax
    from myldpccppapi.codes import encode_numpy
    from myldpccppapi.ops.channel import transmit

    code = wimax(576, "1/2")
    enc = Encoder(code)
    rng = np.random.default_rng(0)
    batch, rounds, budget = 8192, 8, 10
    u = rng.integers(0, 2, size=(batch, code.k), dtype=np.uint8)
    cw = jnp.asarray(encode_numpy(enc.mats, u))
    u_dev = jnp.asarray(u, jnp.int8)
    pos = jnp.asarray(code.info_positions)

    variants = {
        "ms": DecoderConfig(algorithm="min-sum", schedule="flooding",
                            max_iters=budget),
        "scms": DecoderConfig(algorithm="min-sum", schedule="flooding",
                              max_iters=budget, self_correction=True),
        "nms075": DecoderConfig(algorithm="min-sum", schedule="flooding",
                                max_iters=budget, normalization=0.75),
    }
    decs = {k: Decoder(code, v) for k, v in variants.items()}

    rows = []
    for snr_db in (2.0, 2.5, 3.0):
        @jax.jit
        def make_llr(key, s=snr_db):
            return transmit(key, cw, snr_db=s)[0]

        counters = {}
        for k, d in decs.items():
            @jax.jit
            def one(llr, d=d):
                res = d(llr)
                ferr = (res.bits[:, pos].astype(jnp.int8) != u_dev
                        ).any(axis=1)
                return jnp.stack([jnp.sum(jnp.where(ferr, 1, 0)),
                                  jnp.sum(jnp.where(res.converged, 1, 0))])
            counters[k] = one

        agg = {k: np.zeros(2, np.int64) for k in decs}
        for r in range(rounds):
            llr = make_llr(jax.random.PRNGKey(9000 + 100 * int(snr_db * 10)
                                              + r))
            jax.block_until_ready(llr)
            outs = np.asarray(jnp.stack([counters[k](llr) for k in decs]))
            for i, k in enumerate(decs):
                agg[k] += outs[i].astype(np.int64)
        frames = rounds * batch
        row = {"snr_db": snr_db, "frames": frames}
        for k in decs:
            fe, cv = (int(x) for x in agg[k])
            row[k] = {"fer": round(fe / frames, 6), "frame_errors": fe,
                      "conv": round(cv / frames, 4)}
        rows.append(row)
        print(f"[scms] @{snr_db}: " + " ".join(
            f"{k}={row[k]['fer']:.2e}" for k in decs),
            file=sys.stderr, flush=True)
    _emit({"config": "scms", "name": "scms_vs_ms_nms_wimax576_r12_b10",
           "budget_iters": budget, "sweep": rows})


if __name__ == "__main__":
    main()
