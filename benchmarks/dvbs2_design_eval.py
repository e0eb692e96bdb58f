"""Measure the PEXIT-designed 16200 tables against the legacy profile-recall
synthetics on chip (DVB-S2 short FECFRAME, layered NMS 0.85, 30 iters — the
config-3s recipe).

Compares FER at the legacy cliff and scans the designed codes' own cliffs;
PEXIT predicts ~1.1 dB of waterfall shift for both low-rate short frames
(r1/2: 1.275 -> 0.168 dB Eb/N0; r1/3: 0.936 -> -0.213).

Usage: python benchmarks/dvbs2_design_eval.py [r12|r13 ...] (default both).
"""
from __future__ import annotations

import json
import os
import sys

import numpy as np

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

RESULTS = os.path.join(os.path.dirname(os.path.abspath(__file__)),
                       "results.jsonl")
BATCH = 1024


def record(row):
    with open(RESULTS, "a") as f:
        f.write(json.dumps(row) + "\n")
    print(json.dumps(row), flush=True)


def make_step(code):
    import jax

    from myldpccppapi import DecoderConfig
    from myldpccppapi.codes.dvbs2 import ira_encode_fn
    from myldpccppapi.parallel import make_mesh, make_sharded_campaign_step

    cfg = DecoderConfig(schedule="layered", normalization=0.85, max_iters=30)
    mesh = make_mesh((len(jax.devices()),), ("data",))
    return jax.jit(make_sharded_campaign_step(
        code, cfg, mesh, batch_per_device=BATCH // len(jax.devices()),
        num_snr=1, encode_fn=ira_encode_fn(code)))


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


def run(rate: str, legacy_points, scan_points):
    from myldpccppapi.codes.dvbs2 import dvbs2

    for name, code in (
        ("legacy", dvbs2(16200, rate, addresses="legacy")),
        ("designed", dvbs2(16200, rate)),
    ):
        step = make_step(code)
        points = legacy_points if name == "legacy" else scan_points
        for snr_db, frames in points:
            fer, e, t, it = fer_at(step, snr_db, frames, 7000)
            record({"config": "dvbs2_design_eval", "rate": rate,
                    "which": name, "snr_db": snr_db, "fer": round(fer, 7),
                    "errors": e, "frames": t, "mean_iters": round(it, 2)})


if __name__ == "__main__":
    which = sys.argv[1:] or ["r12", "r13"]
    if "r12" in which:
        run("1/2",
            legacy_points=[(1.5, 8192), (1.75, 16384), (2.0, 65536)],
            scan_points=[(0.25, 4096), (0.5, 8192), (0.75, 32768),
                         (1.0, 65536), (1.5, 65536)])
    if "r13" in which:
        # r1/3: rate 1/3, Es/N0 = Eb/N0 - 1.76 dB in this snr convention
        run("1/3",
            legacy_points=[(-0.5, 4096), (-0.25, 8192), (0.0, 16384),
                           (0.25, 65536)],
            scan_points=[(-1.5, 4096), (-1.25, 8192), (-1.0, 32768),
                         (-0.75, 65536), (-0.25, 65536)])
