"""Train and evaluate learned min-sum weight schedules.

Two experiments (results appended to results.jsonl, weights saved as JSON
artifacts):

1. ``headline``: wimax 576 3/4B @5 dB (the headline operating point).
   Trains the kernel-servable TIED per-layer schedule and compares mean
   iterations / straggler fraction / errors against the shipped 0.75
   scalar through the standard dispatch — fewer iterations at equal
   quality = direct throughput.
2. ``fer``: wimax 576 1/2 at a FIXED 10-iteration budget.  Trains a full
   per-iteration x per-layer schedule and measures FER at 2.0/2.5/3.0 dB
   vs the 0.75 scalar (jnp path serves the schedule; the per-layer
   collapse also runs through the standard dispatch), with sum-product as
   the quality ceiling reference.

Usage: python benchmarks/learned_nms.py [headline] [fer]
"""
import json
import os
import sys
import time

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

import jax
import jax.numpy as jnp
import numpy as np

from myldpccppapi import DecoderConfig, Encoder, wimax
from myldpccppapi.codes import encode_numpy
from myldpccppapi.ops.bp import decode_qc
from myldpccppapi.ops.learned import train_nms
from myldpccppapi.decoder import Decoder

RESULTS = os.path.join(os.path.dirname(os.path.abspath(__file__)),
                       "results.jsonl")


def record(row):
    row["ts"] = time.time()
    with open(RESULTS, "a") as f:
        f.write(json.dumps(row) + "\n")
    print(json.dumps(row), flush=True)


def save_weights(name, lw):
    path = os.path.join(os.path.dirname(os.path.abspath(__file__)), name)
    with open(path, "w") as f:
        json.dump({"alpha": lw.alpha.tolist(), "beta": lw.beta.tolist(),
                   "final_loss": lw.losses[-1]}, f, indent=1)
    print(f"saved {path}", flush=True)


def _eval_batches(code, u, cw, decode, snr_db, n_draws, batch, seed0=100,
                  budget=40):
    """Decode ``n_draws`` fresh noise draws; return aggregated stats.
    ``budget`` = the decode's max_iters (the at_cap stat counts frames
    that burned the whole budget)."""
    sigma = 10 ** (-snr_db / 20)
    sym = jax.device_put(jnp.asarray(1.0 - 2.0 * cw.astype(np.float32)))
    u_dev = jax.device_put(jnp.asarray(u, jnp.int8))

    @jax.jit
    def run(key):
        noise = sigma * jax.random.normal(key, sym.shape, jnp.float32)
        llr = 2.0 * (sym + noise) / (sigma * sigma)
        res = decode(llr)
        ferr = jnp.any(res.bits[:, : code.k].astype(jnp.int8) != u_dev,
                       axis=-1)
        return (jnp.sum(res.iterations), jnp.sum(res.converged),
                jnp.sum(ferr), jnp.sum(res.iterations >= budget - 1))

    out = run(jax.random.PRNGKey(seed0 - 1))
    jax.block_until_ready(out)  # warm/compile (not timed)
    tot = np.zeros(4, np.int64)
    for i in range(n_draws):
        tot += np.asarray([int(x) for x in run(jax.random.PRNGKey(seed0 + i))])
    frames = batch * n_draws
    return {
        "frames": frames,
        "mean_iters": tot[0] / frames,
        "conv": tot[1] / frames,
        "fer": tot[2] / frames,
        "at_cap": tot[3] / frames,
    }


def headline():
    code = wimax(576, "3/4B")
    enc = Encoder(code)
    rng = np.random.default_rng(0)
    batch = 8192
    u = rng.integers(0, 2, size=(batch, code.k), dtype=np.uint8)
    cw = encode_numpy(enc.mats, u)

    t0 = time.time()
    lw = train_nms(code, n_iters=8, steps=300, batch=512,
                   snr_db=(4.0, 5.5), lr=0.02, seed=0, tie_iters=True)
    train_s = time.time() - t0
    save_weights("learned_weights_wimax576_r34B_tied.json", lw)
    a, b = lw.config_values(per_layer=True)

    for name, cfg in [
        ("default0.75", DecoderConfig(schedule="layered", normalization=0.75)),
        ("learned_tied", DecoderConfig(schedule="layered", normalization=a,
                                       offset=b)),
    ]:
        stats = _eval_batches(
            code, u, cw, Decoder(code, cfg),
            snr_db=5.0, n_draws=8, batch=batch,
        )
        record({"config": "learned_nms_headline", "setting": name,
                "snr_db": 5.0, "train_s": round(train_s, 1), **stats})


def fer():
    code = wimax(576, "1/2")
    enc = Encoder(code)
    rng = np.random.default_rng(1)
    batch = 2048
    u = rng.integers(0, 2, size=(batch, code.k), dtype=np.uint8)
    cw = encode_numpy(enc.mats, u)

    t0 = time.time()
    lw = train_nms(code, n_iters=10, steps=400, batch=512,
                   snr_db=(1.5, 3.0), lr=0.02, seed=0)
    train_s = time.time() - t0
    save_weights("learned_weights_wimax576_r12_T10.json", lw)
    cfg_iter = lw.decoder_config(
        DecoderConfig(schedule="layered", max_iters=10))
    a_l, b_l = lw.config_values(per_layer=True)

    settings = [
        ("default0.75_jnp",
         DecoderConfig(schedule="layered", normalization=0.75, max_iters=10),
         "jnp"),
        ("learned_iter_jnp", cfg_iter, "jnp"),
        ("learned_layer_auto",
         DecoderConfig(schedule="layered", normalization=a_l, offset=b_l,
                       max_iters=10), "auto"),
        ("sumproduct_jnp",
         DecoderConfig(schedule="layered", algorithm="sum-product",
                       max_iters=10), "jnp"),
    ]
    for snr_db in (2.0, 2.5, 3.0):
        for name, cfg, impl in settings:
            if impl == "auto":
                dec = Decoder(code, cfg)
            else:
                dec = lambda llr, c=cfg: decode_qc(code, c, llr)
            stats = _eval_batches(code, u, cw, dec, snr_db=snr_db,
                                  n_draws=8, batch=batch, budget=10)
            record({"config": "learned_nms_fer", "setting": name,
                    "snr_db": snr_db, "budget": 10,
                    "train_s": round(train_s, 1), **stats})


def bg2():
    """Second family: NR BG2 Z=384 (n=19968, unpunctured) at a fixed
    8-iteration budget, per-layer learned weights through the standard
    dispatch."""
    from myldpccppapi.codes.nr import nr_code, triangular_encode_fn

    code = nr_code(z=384, bg=2)
    enc = triangular_encode_fn(code)
    rng = np.random.default_rng(2)
    batch = 512
    u = rng.integers(0, 2, size=(batch, code.k), dtype=np.uint8)
    cw = np.asarray(enc(jnp.asarray(u)))

    t0 = time.time()
    # 42 layers need more data + the L2 pull: an unregularized 200-step run
    # overfit to alphas up to 1.5 that stalled syndrome clearance entirely
    # (conv ~0).
    # Operating range tracks the PEXIT-designed BG2 default (cliff at
    # -3.25..-3.0 dB; the legacy table's was -1.5..-1.0).  Train AT and
    # above the cliff: a range dominated by hopeless frames (-4.0, -2.75)
    # drove the tied weights to conv=0 everywhere — soft-BER gradients
    # from unconvergeable samples are pure noise.
    lw = train_nms(code, n_iters=8, steps=400, batch=256,
                   snr_db=(-3.0, -1.75), lr=0.01, seed=0, tie_iters=True,
                   reg_to_init=2e-3)
    train_s = time.time() - t0
    save_weights("learned_weights_nr_bg2_z384_tied.json", lw)
    a, b = lw.config_values(per_layer=True)

    settings = [
        ("default0.75", DecoderConfig(schedule="layered", normalization=0.75,
                                      max_iters=8)),
        ("learned_layer",
         DecoderConfig(schedule="layered", normalization=a, offset=b,
                       max_iters=8)),
    ]
    for snr_db in (-3.25, -3.0, -2.75):
        for name, cfg in settings:
            stats = _eval_batches(
                code, u, cw,
                Decoder(code, cfg),
                snr_db=snr_db, n_draws=8, batch=batch, budget=8,
            )
            record({"config": "learned_nms_bg2", "setting": name,
                    "snr_db": snr_db, "budget": 8,
                    "train_s": round(train_s, 1), **stats})


if __name__ == "__main__":
    which = sys.argv[1:] or ["headline", "fer"]
    if "headline" in which:
        headline()
    if "fer" in which:
        fer()
    if "bg2" in which:
        bg2()
