"""Measure the PEXIT-designed BG2 support against the shipped synthetic
default on chip (NR BG2, Z=384, layered NMS 0.8, 30 iters — the exact
nr_table_select operating recipe).

Two questions, answered with FER at matched SNR points:
1. Does the -0.715 dB vs +1.58 dB threshold gap (codes/nr_designed.py vs
   the profile-recall synthetic, codes/pexit.py) survive finite length
   (n = 19968) and 30-iteration decoding?  -> compare at the old default's
   knee/tail and scan the designed code's own waterfall.
2. Which girth-6 shift seed should the designed support ship with?
   -> 4-seed selection by tail FER, like nr_table_select did for the
   original tables.

Usage: python benchmarks/nr_design_eval.py [scan|select|compare] ...
(default: all three).
"""
from __future__ import annotations

import json
import os
import sys

import numpy as np

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

RESULTS = os.path.join(os.path.dirname(os.path.abspath(__file__)),
                       "results.jsonl")
BATCH = 512


def record(row):
    with open(RESULTS, "a") as f:
        f.write(json.dumps(row) + "\n")
    print(json.dumps(row), flush=True)


def make_step(code):
    import jax

    from myldpccppapi import DecoderConfig
    from myldpccppapi.codes.nr import triangular_encode_fn
    from myldpccppapi.parallel import make_mesh, make_sharded_campaign_step

    cfg = DecoderConfig(schedule="layered", normalization=0.8, max_iters=30)
    mesh = make_mesh((len(jax.devices()),), ("data",))
    return jax.jit(make_sharded_campaign_step(
        code, cfg, mesh, batch_per_device=BATCH // len(jax.devices()),
        num_snr=1, encode_fn=triangular_encode_fn(code)))


def fer_at(step, snr_db, frames, seed0):
    import jax
    import jax.numpy as jnp

    errs = tot = iters = 0
    s = seed0
    while tot < frames:
        stats = step(jax.random.PRNGKey(s), jnp.asarray([snr_db], jnp.float32))
        errs += int(np.asarray(stats.frame_errors)[0])
        tot += int(np.asarray(stats.frames)[0])
        iters += int(np.asarray(stats.iterations)[0])
        s += 1
    return errs / tot, errs, tot, iters / tot


def designed_code(z=384, shift_seed=0):
    from myldpccppapi.codes.nr import nr_base_graph, nr_code
    from myldpccppapi.codes.nr_designed import designed_support

    tab = nr_base_graph(2, support=designed_support(2), seed=shift_seed)
    return nr_code(z=z, bg=2, table=tab)


def cmd_compare():
    """Old default vs designed (shift seed 0) at the old knee/tail."""
    from myldpccppapi.codes.nr import nr_code

    for name, code in (("default_synth", nr_code(z=384, bg=2)),
                       ("designed", designed_code())):
        step = make_step(code)
        for snr_db, frames in ((-1.5, 16384), (-1.0, 65536)):
            fer, e, t, it = fer_at(step, snr_db, frames, 5000)
            record({"config": "nr_design_eval", "which": name,
                    "snr_db": snr_db, "fer": round(fer, 7), "errors": e,
                    "frames": t, "mean_iters": round(it, 2)})


def cmd_scan():
    """The designed code's own waterfall (where is its cliff?)."""
    step = make_step(designed_code())
    for snr_db in (-3.5, -3.25, -3.0, -2.75, -2.5, -2.25, -2.0):
        frames = 4096 if snr_db <= -2.75 else 32768
        fer, e, t, it = fer_at(step, snr_db, frames, 9000)
        record({"config": "nr_design_scan", "snr_db": snr_db,
                "fer": round(fer, 7), "errors": e, "frames": t,
                "mean_iters": round(it, 2)})


def cmd_select():
    """Shift-seed selection for the designed support (knee + tail FER)."""
    recs = []
    for seed in (0, 1, 2, 3):
        step = make_step(designed_code(shift_seed=seed))
        knee, ke, kt, _ = fer_at(step, -2.75, 16384, 30000 + seed)
        tail, te, tt, _ = fer_at(step, -2.25, 131072, 40000 + seed)
        rec = {"config": "nr_design_seed_select", "shift_seed": seed,
               "knee_db": -2.75, "knee_fer": round(knee, 6), "knee_errors": ke,
               "tail_db": -2.25, "tail_fer": round(tail, 7), "tail_errors": te,
               "tail_frames": tt}
        record(rec)
        recs.append(rec)
    best = min(recs, key=lambda r: (r["tail_fer"], r["knee_fer"]))
    record({"config": "nr_design_seed_best", "shift_seed": best["shift_seed"],
            "tail_fer": best["tail_fer"], "knee_fer": best["knee_fer"]})


if __name__ == "__main__":
    which = sys.argv[1:] or ["compare", "scan", "select"]
    if "compare" in which:
        cmd_compare()
    if "scan" in which:
        cmd_scan()
    if "select" in which:
        cmd_select()
