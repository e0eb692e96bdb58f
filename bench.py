"""Headline benchmark: decoded info throughput (Mbit/s) on one GPU.

Config: the reference CLI's own code (802.16e n=576, k=432, rate 3/4B —
``Test.cpp:19-26``), batched layered normalized min-sum with syndrome early
exit and two-phase triage, at a fixed SNR/seed.  Each timed call decodes a
distinct noise realization of the batch and ends in ``block_until_ready``;
the reported rate is the median over the calls.  Prints the card's name and
power limit, then ONE JSON line on stdout.

``vs_baseline`` is measured live against the reference's CPU golden decode
path (``Coder::decodeCPU``, ``MyLdpc.cpp:684-784``) ported to C++ and
compiled -O3 on this host (myldpccppapi/native/golden_decoder.cpp): the
reference's GPU numbers were never published (BASELINE.md) and its OpenCL
build cannot run here.  The baseline runs the reference's actual algorithm
(plain flooding min-sum); ours runs this framework's best config — a
system-vs-system comparison at the same operating point.

    python bench.py
"""
from __future__ import annotations

import json
import subprocess
import sys
import time

import numpy as np

SNR_DB = 5.0
BATCH = 8192
CALLS = 20          # timed decode calls, each on its own noise realization
BASELINE_BATCH = 256
SEED = 0


def cpu_baseline_mbits(code, llr) -> float:
    """Reference-algorithm C++ single-core throughput at this operating
    point (plain flooding min-sum, 40-iteration cap): best of two runs."""
    from myldpccppapi import native

    sub = llr[:BASELINE_BATCH]
    if native.decode_golden_native(code, sub, max_iters=40) is None:
        raise RuntimeError("the native golden decoder did not build "
                           "(make -C myldpccppapi/native)")
    best = 0.0
    for _ in range(2):
        t0 = time.perf_counter()
        native.decode_golden_native(code, sub, max_iters=40)
        dt = time.perf_counter() - t0
        best = max(best, len(sub) * code.k / dt / 1e6)
    return best


def main() -> None:
    import jax
    import jax.numpy as jnp

    from myldpccppapi import Decoder, DecoderConfig, Encoder, wimax
    from myldpccppapi.ops.channel import transmit
    from myldpccppapi.utils.runtime import setup_compile_cache

    dev = jax.devices()[0]
    if dev.platform != "gpu":
        raise SystemExit(f"bench.py measures a GPU; JAX found {dev.platform}")
    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True).stdout.strip().splitlines()[0]
    print(f"[bench] card: {card}", file=sys.stderr)
    setup_compile_cache()

    code = wimax(576, "3/4B")
    cfg = DecoderConfig(
        algorithm="min-sum",
        schedule="layered",
        normalization=0.75,
        max_iters=40,
        # two-phase straggler triage (bit-identical, see ops/triage.py)
        triage_iters=5,
    )
    dec = Decoder(code, cfg)

    rng = np.random.default_rng(SEED)
    u = jnp.asarray(rng.integers(0, 2, size=(BATCH, code.k), dtype=np.uint8))
    cw = Encoder(code)(u)
    base = cpu_baseline_mbits(code, np.asarray(transmit(
        jax.random.PRNGKey(SEED), cw[:BASELINE_BATCH], snr_db=SNR_DB)[0]))

    @jax.jit
    def make_llr(key):
        return transmit(key, cw, snr_db=SNR_DB)[0]

    @jax.jit
    def counters(res):
        berr = jnp.sum((res.bits[:, : code.k] != u).astype(jnp.int32))
        return jnp.stack([berr, jnp.sum(~res.converged),
                          jnp.sum(res.iterations)])

    warm = make_llr(jax.random.PRNGKey(SEED + 1))
    jax.block_until_ready(counters(dec(warm)))
    times, agg = [], np.zeros(3, np.int64)
    for i in range(CALLS):
        llr = jax.block_until_ready(make_llr(jax.random.PRNGKey(SEED + 2 + i)))
        t0 = time.perf_counter()
        res = jax.block_until_ready(dec(llr))
        times.append(time.perf_counter() - t0)
        agg += np.asarray(counters(res))
    dt = float(np.median(times))
    berr, unconv, iters_sum = (int(x) for x in agg)
    frames = CALLS * BATCH
    conv_rate = 1.0 - unconv / frames
    assert conv_rate > 0.98, f"bench batch must mostly converge ({conv_rate:.3f})"
    # converged frames decode correctly at this SNR, so every bit error
    # comes from an unconverged frame (bounded by k per frame)
    assert berr <= unconv * code.k
    mbits = BATCH * code.k / dt / 1e6
    print(
        f"[bench] impl={dec.implementation} conv={conv_rate:.4f} "
        f"iters={iters_sum / frames:.2f} batch={BATCH} calls={CALLS} "
        f"median_ms={dt * 1e3:.3f} p90_ms={np.percentile(times, 90) * 1e3:.3f} "
        f"rate={mbits:.1f} Mbit/s cpu_baseline={base:.3f} Mbit/s "
        f"[{card}]",
        file=sys.stderr,
    )
    print(json.dumps({
        "metric": "decoded_info_throughput_n576_r34B_layered_nms_5dB",
        "value": round(mbits, 3),
        "unit": "Mbit/s",
        "vs_baseline": round(mbits / base, 2),
        "median_ms": round(dt * 1e3, 4),
        "device": {"platform": dev.platform, "kind": dev.device_kind,
                   "count": len(jax.devices())},
        "card": card,
        "implementation": dec.implementation,
    }))


if __name__ == "__main__":
    main()
