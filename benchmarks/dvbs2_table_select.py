"""Select the default synthetic DVB-S2 address table by measured FER.

Companion to :mod:`benchmarks.nr_table_select` (same rationale: all
candidates are 4-cycle-free where achievable, but girth-6 tables still
spread widely in knee/floor FER, and published tables are finalized by
simulation).  Evaluates candidate seeds of
``codes/dvbs2.synthetic_address_table`` at a knee and a tail operating
point of the n=16200 r1/2 short-FECFRAME waterfall on the chip.

Usage::

    python benchmarks/dvbs2_table_select.py [n] [seed seed ...]
"""
from __future__ import annotations

import json
import os
import sys

import numpy as np

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

RESULTS = os.path.join(os.path.dirname(os.path.abspath(__file__)), "results.jsonl")

KNEE_DB, KNEE_FRAMES = 1.75, 32768
TAIL_DB, TAIL_FRAMES = 2.0, 131072
BATCH = 1024


def eval_seed(n: int, seed: int) -> dict:
    import jax
    import jax.numpy as jnp

    from myldpccppapi import DecoderConfig
    from myldpccppapi.codes.dvbs2 import (dvbs2_ira_qc, ira_encode_fn,
                                              synthetic_address_table)
    from myldpccppapi.parallel import make_mesh, make_sharded_campaign_step

    code = dvbs2_ira_qc(n, "1/2",
                        addresses=synthetic_address_table(n, "1/2", seed))
    cfg = DecoderConfig(schedule="layered", normalization=0.85, max_iters=30)
    mesh = make_mesh((len(jax.devices()),), ("data",))
    step = jax.jit(make_sharded_campaign_step(
        code, cfg, mesh, batch_per_device=BATCH // len(jax.devices()),
        num_snr=1, encode_fn=ira_encode_fn(code)))

    def fer_at(snr_db: float, frames: int, seed0: int) -> tuple:
        errs = tot = 0
        s = seed0
        while tot < frames:
            stats = step(jax.random.PRNGKey(s),
                         jnp.asarray([snr_db], jnp.float32))
            errs += int(np.asarray(stats.frame_errors)[0])
            tot += int(np.asarray(stats.frames)[0])
            s += 1
        return errs / tot, errs, tot

    knee, ke, kt = fer_at(KNEE_DB, KNEE_FRAMES, 30_000 * (seed + 1))
    tail, te, tt = fer_at(TAIL_DB, TAIL_FRAMES, 40_000 * (seed + 1))
    rec = {"config": "dvbs2_table_select", "n": n, "seed": seed,
           "knee_db": KNEE_DB, "knee_fer": round(knee, 6),
           "knee_errors": ke, "knee_frames": kt,
           "tail_db": TAIL_DB, "tail_fer": round(tail, 7),
           "tail_errors": te, "tail_frames": tt}
    print(json.dumps(rec), flush=True)
    return rec


def main():
    args = sys.argv[1:]
    n = int(args[0]) if args else 16200
    seeds = [int(s) for s in args[1:]] or [0, 1, 2, 3]
    recs = [eval_seed(n, s) for s in seeds]
    best = min(recs, key=lambda r: (r["tail_fer"], r["knee_fer"]))
    print(json.dumps({"config": "dvbs2_table_select_best", "n": n,
                      "seed": best["seed"], "tail_fer": best["tail_fer"],
                      "knee_fer": best["knee_fer"]}), flush=True)
    with open(RESULTS, "a") as f:
        for r in recs:
            f.write(json.dumps(r) + "\n")


if __name__ == "__main__":
    main()
