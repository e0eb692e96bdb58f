"""Smoke run of the LDPC receive path on one NVIDIA GPU.

    python chip_smoke.py            # every phase, one card
    python chip_smoke.py --four     # only the sharded campaign, four cards

Drives the public entry points (Encoder / transmit / Decoder, sim_step, the
byte-stream Coder) at the batch sizes of the BASELINE configurations and
checks every result against the repo's references: the jnp/XLA decode path,
the native C++ golden decoders, and the numpy encoders.  The fused CUDA
decoder runs as compiled for the card; the ``gpu``-marked tests run too.
Timing lines name the card and its power limit.  Any failed phase makes the
exit code non-zero; on success the last line is one JSON object naming the
device.  Without a GPU the script stops before any work.
"""
from __future__ import annotations

import argparse
import dataclasses
import json
import os
import subprocess
import sys
import time
import traceback

import numpy as np

ROOT = os.path.dirname(os.path.abspath(__file__))


def _card() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60)
    return out.stdout.strip()


class Smoke:
    def __init__(self, card: str):
        self.card = card.splitlines()[0]
        self.failed: list[str] = []

    def phase(self, name, fn, *args):
        print(f"== {name}", flush=True)
        t0 = time.perf_counter()
        try:
            fn(*args)
        except Exception:  # recorded; the run exits non-zero below
            traceback.print_exc()
            self.failed.append(name)
            print(f"== {name} FAILED ({time.perf_counter() - t0:.1f} s)",
                  flush=True)
            return
        print(f"== {name} ok ({time.perf_counter() - t0:.1f} s, "
              f"card {self.card})", flush=True)


def _check(cond, msg):
    if not cond:
        raise AssertionError(msg)


def _llr_batch(code, u_bits, snr_db, key):
    """Encode on the device, check it against the numpy encoder, transmit."""
    import jax
    import jax.numpy as jnp

    from myldpccppapi import Encoder
    from myldpccppapi.codes import encode_numpy
    from myldpccppapi.ops.channel import transmit

    enc = Encoder(code)
    cw = enc(jnp.asarray(u_bits))
    _check((np.asarray(cw) == encode_numpy(enc.mats, u_bits)).all(),
           "device encode differs from encode_numpy")
    llr, _ = transmit(jax.random.PRNGKey(key), cw, snr_db=snr_db)
    return llr


def _compare(name, res, ref):
    """Hard bits equal on frames both converged; iteration counts equal on
    >= 99% of frames."""
    bits, conv, iters = (np.asarray(res[0]), np.asarray(res[1]),
                         np.asarray(res[2]))
    rb, rc, ri = (np.asarray(ref[0]), np.asarray(ref[1]), np.asarray(ref[2]))
    both = conv & rc
    same_bits = (bits[both] == rb[both]).all()
    same_iters = float(np.mean(iters == ri))
    print(f"   vs {name}: frames={len(conv)} both_converged={int(both.sum())} "
          f"bits_equal={bool(same_bits)} iters_equal={same_iters:.4f}")
    _check(both.any(), f"{name}: no frame converged in both")
    _check(same_bits, f"{name}: hard bits differ on converged frames")
    _check(same_iters >= 0.99, f"{name}: iteration counts differ on "
                               f"{1 - same_iters:.2%} of frames")


def _decode_and_check(code, cfg, llr, u, golden_fn, golden_frames):
    """Decoder(auto) on the batch: convergence, bit errors, and agreement
    with the jnp path (when dispatch chose a kernel) and the golden."""
    from myldpccppapi import Decoder

    dec = Decoder(code, cfg)
    res = dec(llr)
    bits = np.asarray(res.bits)
    conv = np.asarray(res.converged)
    iters = np.asarray(res.iterations)
    info = np.asarray(code.info_positions)
    berr = int((bits[:, info] != u).sum())
    unconv = int((~conv).sum())
    print(f"   impl={dec.implementation} batch={len(conv)} "
          f"conv_rate={conv.mean():.5f} mean_iters={iters.mean():.3f} "
          f"bit_errors={berr} unconverged={unconv}")
    _check(conv.mean() > 0.98, "convergence rate must exceed 0.98")
    _check(berr <= unconv * code.k_info,
           "bit errors beyond the unconverged frames")
    if dec.implementation != "jnp":
        ref = Decoder(code, dataclasses.replace(cfg, implementation="jnp"))(
            llr)
        _compare("jnp", (bits, conv, iters),
                 (ref.bits, ref.converged, ref.iterations))
    sub = np.asarray(llr[:golden_frames], np.float32)
    gold = golden_fn(code, sub, max_iters=cfg.max_iters,
                     normalization=cfg.normalization, offset=cfg.offset)
    _check(gold is not None, "the native golden decoder must build")
    _compare("native golden", (bits[:golden_frames], conv[:golden_frames],
                               iters[:golden_frames]), gold)


def phase_card_tests():
    """The gpu-marked tests, on the card."""
    import pytest

    os.environ["MYLDPC_TESTS_ON_GPU"] = "1"
    rc = pytest.main(["-q", "-m", "gpu", "-p", "no:cacheprovider",
                      os.path.join(ROOT, "tests", "test_cuda_decoder.py")])
    _check(rc == 0, f"gpu tests failed (pytest exit code {int(rc)})")


def phase_headline():
    """802.16e n=576 r3/4B (Test.cpp:19-26), bench.py's config, batch 8192
    at 5 dB: Encoder -> transmit -> Decoder(auto)."""
    from myldpccppapi import DecoderConfig, native, wimax

    code = wimax(576, "3/4B")
    cfg = DecoderConfig(algorithm="min-sum", schedule="layered",
                        normalization=0.75, max_iters=40, triage_iters=5)
    u = np.random.default_rng(0).integers(0, 2, (8192, code.k), np.uint8)
    llr = _llr_batch(code, u, 5.0, key=1)
    _decode_and_check(code, cfg, llr, u, native.decode_golden_layered_native,
                      256)


def phase_flooding():
    """The reference's MS / MSCL types (flooding min-sum, 120-iteration
    cap) on 802.11n n=1944 r5/6, batch 4096."""
    from myldpccppapi import native
    from myldpccppapi.coder import DECODE_TYPES
    from myldpccppapi.codes.wifi import wifi

    code = wifi(1944, "5/6")
    cfg = DECODE_TYPES["MSCL"]
    u = np.random.default_rng(1).integers(0, 2, (4096, code.k), np.uint8)
    llr = _llr_batch(code, u, 7.0, key=2)
    _decode_and_check(code, cfg, llr, u, native.decode_golden_flooding_native,
                      256)


def phase_long_code():
    """DVB-S2 n=64800 r1/2, batch 1024 at 1.4 dB (BASELINE config 3)."""
    import jax
    import jax.numpy as jnp

    from myldpccppapi import DecoderConfig, native
    from myldpccppapi.codes.dvbs2 import dvbs2, ira_encode_fn, ira_encode_numpy
    from myldpccppapi.ops.channel import transmit

    code = dvbs2(64800, "1/2")
    cfg = DecoderConfig(schedule="layered", normalization=0.85, max_iters=30)
    u = np.random.default_rng(2).integers(0, 2, (1024, code.k), np.uint8)
    cw = jax.jit(ira_encode_fn(code))(jnp.asarray(u, jnp.int8))
    _check((np.asarray(cw) == ira_encode_numpy(code, u)).all(),
           "device IRA encode differs from ira_encode_numpy")
    llr, _ = transmit(jax.random.PRNGKey(3), cw, snr_db=1.4)
    _decode_and_check(code, cfg, llr, u, native.decode_golden_layered_native,
                      16)


def phase_nr_crc():
    """NR BG1 with CRC24B-aided acceptance, batch 512 at 5 dB, through
    sim_step: Z=384 (BASELINE config 4's code, jnp path: CRC folded into
    the early-exit latch) and Z=64 with triage (fused kernel under
    ops/crc_accept.py and ops/triage.py)."""
    import functools

    import jax

    from myldpccppapi import DecoderConfig
    from myldpccppapi.codes.nr import nr_code, triangular_encode_fn
    from myldpccppapi.parallel.sim import make_decode_fn, sim_step

    cfg = DecoderConfig(schedule="layered", normalization=0.8, max_iters=30,
                        crc="24B")
    for z, triage in ((384, 0), (64, 4)):
        code = nr_code(z=z, bg=1)
        cfg = dataclasses.replace(cfg, triage_iters=triage)
        dec = make_decode_fn(code, cfg)
        step = jax.jit(functools.partial(
            sim_step, code, cfg, batch=512,
            encode_fn=triangular_encode_fn(code), decode_fn=dec))
        s = jax.tree.map(int, step(jax.random.PRNGKey(4), 5.0))
        print(f"   Z={z} triage_iters={triage} impl={dec.implementation} "
              f"frames={s.frames} "
              f"frame_errors={s.frame_errors} undetected_errors="
              f"{s.undetected_errors} crc_rejected={s.crc_rejected} "
              f"unconverged={s.unconverged} "
              f"mean_iters={s.iterations / s.frames:.3f}")
        _check(s.frames == 512, "frame count")
        _check(s.undetected_errors == 0,
               "undetected errors under CRC acceptance")


def phase_byte_stream():
    """The byte-stream Coder on the `test 4320 64 5.0 TDMP` CLI case."""
    from myldpccppapi.coder import Coder

    coder = Coder(432, 576, "3/4B")
    coder.for_encoder()
    coder.for_decoder(64)
    src = bytes((ord("a") + i % 26) for i in range(4320))
    prior = coder.encode(src)
    post = coder.test(prior, 10 ** (-5.0 / 20), seed=0)
    kb = 432 // 8
    truth = np.frombuffer(src, np.uint8)
    # TDMP names the jnp layered decoder, TDMPCL the fused one (auto)
    for de_type in ("TDMP", "TDMPCL"):
        out, stats = coder.decode(post, len(src), de_type=de_type,
                                  return_stats=True)
        bad = (truth != out).reshape(-1, kb).any(axis=1)
        conv = stats["converged"]
        print(f"   {de_type}: impl={coder._decoders[de_type].implementation} "
              f"codewords={len(conv)} converged={int(conv.sum())} "
              f"codewords_with_errors={int(bad.sum())}")
        _check(not (bad & conv).any(),
               "a converged codeword decoded wrong bytes")
        _check(conv.mean() > 0.9, "most codewords converge at 5 dB")


def _time_decode(fn, inputs, reps):
    """Median wall time of one fn(llr) call over distinct inputs, each
    ended by block_until_ready, after one warm-up call per input shape."""
    import jax

    jax.block_until_ready(fn(inputs[0]))
    times = []
    for i in range(reps):
        t0 = time.perf_counter()
        jax.block_until_ready(fn(inputs[1 + i % (len(inputs) - 1)]))
        times.append(time.perf_counter() - t0)
    return float(np.median(times))


def phase_face_off(card):
    """Fused CUDA kernel vs the jnp/XLA path, end to end through the
    Decoder, at the shapes the kernel serves in the benchmark configs."""
    import jax
    import jax.numpy as jnp

    from myldpccppapi import Decoder, DecoderConfig, Encoder, wimax
    from myldpccppapi.codes.wifi import wifi
    from myldpccppapi.coder import DECODE_TYPES
    from myldpccppapi.ops.channel import transmit

    shapes = [
        ("wimax576_r34B_b8192_layered_triage5", wimax(576, "3/4B"),
         DecoderConfig(normalization=0.75, max_iters=40, triage_iters=5),
         8192, 5.0),
        ("wifi1944_r56_b4096_layered_nms", wifi(1944, "5/6"),
         DecoderConfig(normalization=0.75), 4096, 6.5),
        ("wifi1944_r56_b4096_flooding_mscl", wifi(1944, "5/6"),
         DECODE_TYPES["MSCL"], 4096, 7.0),
    ]
    for name, code, cfg, batch, snr in shapes:
        u = jnp.asarray(np.random.default_rng(5).integers(
            0, 2, (batch, code.k), np.uint8))
        cw = Encoder(code)(u)
        inputs = [transmit(jax.random.PRNGKey(100 + i), cw, snr_db=snr)[0]
                  for i in range(6)]
        jax.block_until_ready(inputs)
        fast = Decoder(code, cfg)
        _check(fast.implementation == "cuda", f"{name}: dispatch chose "
                                              f"{fast.implementation}")
        ref = Decoder(code, dataclasses.replace(cfg, implementation="jnp"))
        t_k = _time_decode(fast, inputs, 10)
        t_j = _time_decode(ref, inputs, 10)
        bits = batch * code.k
        print(f"   face-off {name}: cuda {bits / t_k / 1e6:.1f} Mbit/s "
              f"({t_k * 1e3:.3f} ms) jnp {bits / t_j / 1e6:.1f} Mbit/s "
              f"({t_j * 1e3:.3f} ms) speedup {t_j / t_k:.2f}x "
              f"[card {card}]", flush=True)


def phase_four(card):
    """The sharded campaign step on a (snr=2, data=2) mesh of four cards,
    512 frames per card per SNR point, against the same shards replayed on
    one card: frame and error counts must be equal."""
    import jax
    import jax.numpy as jnp

    sys.path.insert(0, ROOT)
    from __graft_entry__ import multichip_legs
    from myldpccppapi.parallel import make_sharded_campaign_step
    from myldpccppapi.parallel.sim import serial_campaign_step

    bpd = 512
    mesh, snr_axis, num_snr, legs = multichip_legs(4)
    _check(dict(mesh.shape) == {"snr": 2, "data": 2}, f"mesh {mesh.shape}")
    for name, code, cfg, enc_fn, dec_fn, outer, lo, hi in legs:
        snr = jnp.linspace(lo, hi, num_snr, dtype=jnp.float32)
        step = jax.jit(make_sharded_campaign_step(
            code, cfg, mesh, batch_per_device=bpd, num_snr=num_snr,
            snr_axis=snr_axis, encode_fn=enc_fn, decode_fn=dec_fn,
            outer=outer))
        key = jax.random.PRNGKey(0)
        sharded = jax.tree.map(np.asarray, step(key, snr))
        t0 = time.perf_counter()
        sharded = jax.tree.map(np.asarray, step(key, snr))
        dt = time.perf_counter() - t0
        serial = jax.tree.map(np.asarray, serial_campaign_step(
            code, cfg, key, snr, mesh.shape["data"], mesh.shape["snr"], bpd,
            encode_fn=enc_fn, decode_fn=dec_fn, outer=outer))
        fields = ("frames", "frame_errors", "bit_errors", "unconverged",
                  "undetected_errors", "crc_rejected", "iterations")
        equal = all((getattr(sharded, f) == getattr(serial, f)).all()
                    for f in fields)
        print(f"   {name}: mesh={dict(mesh.shape)} frames="
              f"{sharded.frames.tolist()} frame_errors="
              f"{sharded.frame_errors.tolist()} bit_errors="
              f"{sharded.bit_errors.tolist()} one-card replay equal={equal} "
              f"step {dt * 1e3:.1f} ms [card {card}]", flush=True)
        _check(int(sharded.frames.sum()) == num_snr * bpd * 2, "frame total")
        _check(equal, f"{name}: sharded statistics differ from the one-card "
                      "replay")


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--four", action="store_true",
                    help="run only the sharded campaign on four GPUs")
    args = ap.parse_args(argv)

    import jax

    devices = jax.devices()
    if devices[0].platform != "gpu":
        print(f"chip_smoke: needs an NVIDIA GPU; JAX found "
              f"{devices[0].platform}", file=sys.stderr)
        return 2
    need = 4 if args.four else 1
    if len(devices) < need:
        print(f"chip_smoke: needs {need} GPUs, found {len(devices)}",
              file=sys.stderr)
        return 2
    card = _card()
    print(f"nvidia-smi: {card}", flush=True)

    sys.path.insert(0, ROOT)
    from myldpccppapi.utils.runtime import setup_compile_cache

    print(f"compile cache: {setup_compile_cache()}")
    smoke = Smoke(card)
    if args.four:
        smoke.phase("four-card sharded campaign", phase_four, smoke.card)
    else:
        smoke.phase("headline 802.16e n=576 r3/4B", phase_headline)
        smoke.phase("flooding min-sum 802.11n n=1944 r5/6", phase_flooding)
        smoke.phase("long code DVB-S2 n=64800 r1/2", phase_long_code)
        smoke.phase("NR BG1 Z=384 CRC24B flow", phase_nr_crc)
        smoke.phase("byte-stream Coder", phase_byte_stream)
        smoke.phase("kernel face-off", phase_face_off, smoke.card)
        smoke.phase("gpu-marked tests", phase_card_tests)
    if smoke.failed:
        print(f"chip_smoke: FAILED phases: {smoke.failed}", file=sys.stderr)
        return 1
    dev = jax.devices()[0]
    print(json.dumps({"ok": True, "device": {
        "platform": dev.platform, "kind": dev.device_kind,
        "count": len(jax.devices())}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
