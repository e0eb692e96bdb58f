"""Command-line harness.

``test``      — the reference CLI's encode -> AWGN -> decode roundtrip
                (``Test.cpp:15-118``): same positional semantics
                (srcLength, batchSize, snr, algo), same printed metrics
                (decode wall time, ErrNum, ThroughPut), modern flags.
``waterfall`` — BER/FER campaign over an SNR grid with checkpoint/resume
                and CSV/JSON emission (the §5 machinery the reference lacks).
``bench``     — one-config throughput benchmark (same JSON line as bench.py).

Examples::

    python -m myldpccppapi test 4320 64 3.0 TDMP
    python -m myldpccppapi waterfall --family wimax --n 576 --rate 1/2 \
        --snr 0:4:0.5 --batch 1024 --target-errors 200 --out waterfall.csv
"""
from __future__ import annotations

import argparse
import json
import sys
import time

import numpy as np

from .utils.config import DecoderConfig


def _parse_snr_grid(spec: str):
    """"a:b:step" inclusive grid, or comma list "1,2,3"."""
    if ":" in spec:
        parts = [float(x) for x in spec.split(":")]
        a, b = parts[0], parts[1]
        step = parts[2] if len(parts) > 2 else 1.0
        n = int(round((b - a) / step)) + 1
        return [round(a + i * step, 6) for i in range(n)]
    return [float(x) for x in spec.split(",")]


def _make_code(args):
    if args.family == "wimax":
        from .codes import wimax

        return wimax(args.n, args.rate)
    if args.family == "wifi":
        from .codes import wifi

        return wifi(args.n, args.rate)
    if args.family == "regular":
        from .codes import regular

        return regular(args.n)
    if args.family == "nr":
        from .codes import nr_code

        return nr_code(z=args.z, bg=args.bg)
    if args.family == "dvbs2":
        # the blessed constructor: EN 302 307 IRA structure in z=360 QC
        # form — O(n) accumulator encode
        from .codes import dvbs2

        return dvbs2(args.n, args.rate)
    if args.family == "rs_ldpc":
        # 802.3an-class RS-based LDPC: n = 32 * 2^s (2048 = the standard's)
        from .codes.rs_ldpc import rs_ldpc_from_n

        try:
            return rs_ldpc_from_n(args.n)
        except ValueError as e:
            raise SystemExit(str(e))
    raise SystemExit(f"unknown family {args.family}")


def cmd_test(args) -> int:
    """Reference-style roundtrip: plaintext -> encode -> AWGN -> decode."""
    from .coder import Coder

    coder = Coder(args.k, args.n, args.rate)
    coder.for_encoder()
    coder.for_decoder(args.batch)
    src = bytes((ord("a") + i % 26) for i in range(args.src_length))

    t0 = time.perf_counter()
    prior = coder.encode(src)
    t_enc = time.perf_counter() - t0
    sigma = 10 ** (-args.snr / 20)
    post = coder.test(prior, sigma, seed=args.seed)

    # arming: compile the decode program outside the timed region, like the
    # reference's forDecoder/addDecodeType device setup (MyLdpc.cpp:167-552)
    # happens before its timed decode (Test.cpp:63-103)
    if args.algo != "CPU":
        # same stream length => identical chunk shapes => full jit cache
        coder.decode(np.zeros_like(post), len(src), de_type=args.algo)

    t0 = time.perf_counter()
    decoded, stats = coder.decode(post, len(src), de_type=args.algo,
                                  return_stats=True)
    t_dec = time.perf_counter() - t0

    err = int(np.sum(np.frombuffer(src, np.uint8) != decoded[: len(src)]))
    print(f"EncodeTime={t_enc:.6f}s DecodeTime={t_dec:.6f}s")
    # the reference prints the BP iteration count per batch ("Time=<iters>",
    # MyLdpc.cpp:838)
    print(f"Time={stats['mean_iters']:.1f}")
    print(f"ErrNum={err}")
    print(f"ThroughPut={len(src) / t_dec:.1f} byte/s")
    return 0 if err == 0 else 1


def cmd_waterfall(args) -> int:
    import jax
    import jax.numpy as jnp

    from .campaign import CampaignConfig, WaterfallCampaign
    from .parallel import make_mesh, make_sharded_campaign_step

    code = _make_code(args)
    cfg = DecoderConfig(
        algorithm=args.algorithm,
        schedule=args.schedule,
        max_iters=args.max_iters,
        normalization=args.normalization,
        msg_dtype=getattr(args, "msg_dtype", "float32"),
        crc=getattr(args, "crc", None),
        self_correction=getattr(args, "self_correction", False),
    )
    snr_grid = _parse_snr_grid(args.snr)

    n_dev = len(jax.devices())
    snr_shards = max(1, getattr(args, "snr_shards", 1))
    if n_dev % snr_shards:
        raise SystemExit(
            f"--snr-shards {snr_shards} must divide device count {n_dev}"
        )
    if snr_shards > 1:
        # the BASELINE config-5 layout: SNR points across one mesh axis,
        # codeword batch across the other
        mesh = make_mesh((snr_shards, n_dev // snr_shards), ("snr", "data"))
    else:
        mesh = make_mesh((n_dev,), ("data",))
    data_devs = n_dev // snr_shards
    # the decoder always comes from the standard implementation dispatch;
    # only the encoder is family-specific
    encode_fn = None
    if args.family == "dvbs2":
        # O(n) accumulator encoder; the decoder comes from the standard
        # implementation dispatch
        from .codes.dvbs2 import ira_encode_fn

        encode_fn = ira_encode_fn(code)
    elif args.family == "nr":
        from .codes.nr import triangular_encode_fn

        encode_fn = triangular_encode_fn(code)
    outer = None
    if getattr(args, "bch", False):
        if args.family != "dvbs2":
            raise SystemExit("--bch is the DVB-S2 outer code; use --crc "
                             "for other families")
        if args.crc:
            raise SystemExit("--crc and --bch are mutually exclusive "
                             "acceptance modes")
        from .codes.bch import bch_params_dvbs2

        m_f, t_f, _ = bch_params_dvbs2(args.n, args.rate)
        outer = ("bch", m_f, t_f)
    mod = None
    mod_name = getattr(args, "mod", "bpsk") or "bpsk"
    if mod_name != "bpsk":
        from .ops.modulation import make_modulation

        mod = make_modulation(mod_name, rate=args.rate)
        if code.n % mod.bits_per_symbol:
            raise SystemExit(
                f"n={code.n} not divisible by {mod.bits_per_symbol} "
                f"bits/symbol of {mod_name}"
            )
    step = make_sharded_campaign_step(
        code, cfg, mesh,
        batch_per_device=max(1, args.batch // data_devs),
        num_snr=snr_shards,
        encode_fn=encode_fn,
        snr_axis="snr" if snr_shards > 1 else None,
        outer=outer,
        mod=mod,
        demap=getattr(args, "demap", "maxlog"),
        id_outer=getattr(args, "id_outer", 0),
    )
    step = jax.jit(step)

    def step_fn(seed, snr_db):
        snrs = snr_db if isinstance(snr_db, (list, tuple)) else [snr_db]
        stats = step(
            jax.random.PRNGKey(seed), jnp.asarray(snrs, jnp.float32)
        )
        return jax.tree.map(np.asarray, stats)

    ccfg = CampaignConfig(
        snr_db=snr_grid,
        batch_per_step=args.batch,
        min_frame_errors=args.target_errors,
        max_frames=args.max_frames,
        seed=args.seed,
    )
    fp = ccfg.fingerprint(
        code.name,
        repr(cfg) + f"/snr_shards={snr_shards}/outer={outer}"
        + (f"/mod={mod_name}/demap={args.demap}"
           f"/id_outer={getattr(args, 'id_outer', 0)}"
           if mod is not None else ""),
    )
    camp = WaterfallCampaign(
        ccfg, step_fn,
        frames_per_step=max(1, args.batch // data_devs) * data_devs,
        fingerprint=fp,
        checkpoint_path=args.checkpoint,
        snr_group_size=snr_shards,
    )

    def progress(i, p):
        if args.verbose:
            print(
                f"snr={p.snr_db:+.2f} frames={p.frames} fer={p.fer:.3e} "
                f"ber={p.ber:.3e} iters={p.avg_iters:.1f}",
                file=sys.stderr,
            )

    camp.run(progress=progress)
    if args.out:
        if args.out.endswith(".json"):
            with open(args.out, "w") as f:
                json.dump(camp.report(), f, indent=2)
        else:
            camp.write_csv(args.out)
    for p in camp.points:
        split = ""
        if p.frame_errors:
            rej = args.crc or getattr(args, "bch", False)
            split = (f" det/undet={p.detected_errors}/{p.undetected_errors}"
                     + (f" outer_rej={p.crc_rejected}" if rej else ""))
        print(
            f"snr={p.snr_db:+.2f} frames={p.frames} FER={p.fer:.4e} "
            f"BER={p.ber:.4e} (+-{p.fer_ci95():.1e}) iters={p.avg_iters:.2f}"
            + split
        )
    return 0


def cmd_threshold(args) -> int:
    """PEXIT decoding threshold of a code family (host-side analysis)."""
    import math

    from .codes.pexit import protograph, threshold_ebn0

    code = _make_code(args)
    thr = threshold_ebn0(code)
    pf = getattr(code, "punctured_front", 0)
    rate = code.k_info / (code.n - pf)
    print(f"code={code.name} rate_tx={rate:.4f} "
          f"edges={int(protograph(code).sum())}")
    print(f"threshold_ebn0_db={thr:.3f}")
    # sigma* derives from thr in closed form — do not pay a second
    # bisection (threshold_sigma re-runs the whole search)
    sigma = (0.0 if not math.isfinite(thr)
             else 1.0 / math.sqrt(2.0 * rate * 10.0 ** (thr / 10.0)))
    print(f"threshold_sigma={sigma:.4f}")
    return 0


def cmd_design(args) -> int:
    """PEXIT-guided base-graph / profile design (host-side search)."""
    import numpy as np

    if args.family == "nr":
        from .codes.design import nr_support_default, optimize_nr_support
        from .codes.design import _threshold as nr_threshold

        start = nr_support_default(args.bg)
        t0 = nr_threshold(start.astype(int), args.bg, -3.0, 10.0, 0.02)
        b, thr = optimize_nr_support(bg=args.bg, steps=args.steps,
                                     seed=args.seed,
                                     log_every=args.steps // 10 or 1)
        print(f"legacy threshold:   {t0:.3f} dB")
        print(f"designed threshold: {thr:.3f} dB  ({b.sum()} edges)")
        if args.out:
            np.save(args.out, b)
            print(f"support saved to {args.out} — lift with "
                  f"nr_code(bg={args.bg}, table=nr_base_graph({args.bg}, "
                  f"support=np.load(...)))")
        return 0
    if args.family == "dvbs2":
        from .codes.design import (
            optimize_dvbs2_profile, realize_dvbs2_addresses,
        )

        bi, thr = optimize_dvbs2_profile(
            args.n, args.rate, steps=args.steps, seed=args.seed,
            log_every=args.steps // 10 or 1)
        print(f"designed threshold: {thr:.3f} dB  ({bi.sum()} edges)")
        addrs = realize_dvbs2_addresses(bi, args.n, args.rate)
        if args.out:
            with open(args.out, "w") as f:
                for a in addrs:
                    f.write(" ".join(str(x) for x in a) + "\n")
            print(f"address table saved to {args.out} — load with "
                  f"dvbs2(n, rate, addresses=parse_address_table(open(...)"
                  f".read()))")
        return 0
    raise SystemExit(f"design supports families nr, dvbs2 (got {args.family})")


def cmd_probe(args) -> int:
    """Error-impulse floor probe: d_min bound + trapped-set fingerprint."""
    from .ops.impulse import impulse_probe

    code = _make_code(args)
    r = impulse_probe(code, amplitude=args.amplitude,
                      max_pair_patterns=args.max_pairs)
    print(f"code={code.name} probes={r.probes} amplitude={args.amplitude}")
    if r.min_weight is not None:
        print(f"min_weight={r.min_weight} "
              f"support_cols={r.support_cols.tolist()}")
    else:
        print("min_weight=none (no impulse broke through to a codeword)")
    print(f"breaches={r.breaches} trapped={len(r.trapped)}")
    return 0


def cmd_bench(args) -> int:
    # bench.py lives at the repo root, outside the package: resolve it
    # relative to this file so `python -m myldpccppapi bench` works from
    # any CWD
    import importlib.util
    import pathlib

    path = pathlib.Path(__file__).resolve().parent.parent / "bench.py"
    spec = importlib.util.spec_from_file_location("bench", path)
    bench = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(bench)
    bench.main()
    return 0


def build_parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(prog="myldpccppapi")
    p.add_argument("--platform", default=None,
                   help='force a JAX platform, e.g. "cpu"')
    p.add_argument("--cpu-devices", type=int, default=None,
                   help="number of virtual CPU devices (for mesh testing)")
    sub = p.add_subparsers(dest="cmd", required=True)

    t = sub.add_parser("test", help="reference-style roundtrip self-test")
    t.add_argument("src_length", type=int)
    t.add_argument("batch", type=int)
    t.add_argument("snr", type=float)
    t.add_argument(
        "algo",
        choices=["CPU", "MS", "SP", "TDMP", "MSCL", "TDMPCL", "BF", "SCMS"],
        help="decode type (reference Test.cpp names, plus the BF/SCMS "
             "tiers this framework adds)",
    )
    t.add_argument("--n", type=int, default=576)
    t.add_argument("--k", type=int, default=432)
    t.add_argument("--rate", default="3/4B")
    t.add_argument("--seed", type=int, default=0)
    t.set_defaults(fn=cmd_test)

    w = sub.add_parser("waterfall", help="BER/FER waterfall campaign")
    w.add_argument("--family", default="wimax",
                   choices=["wimax", "wifi", "regular", "nr", "dvbs2",
                            "rs_ldpc"])
    w.add_argument("--n", type=int, default=576)
    w.add_argument("--rate", default="1/2")
    w.add_argument("--z", type=int, default=384, help="NR lifting size")
    w.add_argument("--bg", type=int, default=1, help="NR base graph")
    w.add_argument("--snr", default="0:4:0.5", help='grid "a:b:step" or "1,2,3"')
    w.add_argument("--batch", type=int, default=1024)
    w.add_argument("--algorithm", default="min-sum",
                   choices=["min-sum", "sum-product"])
    w.add_argument("--schedule", default="layered",
                   choices=["layered", "flooding"])
    w.add_argument("--max-iters", type=int, default=40)
    w.add_argument("--normalization", type=float, default=1.0)
    w.add_argument("--self-correction", action="store_true",
                   dest="self_correction",
                   help="SCMS (Savin): sign-flip message erasure — "
                        "min-sum flooding only, no tuned constant needed")
    w.add_argument("--msg-dtype", default="float32",
                   choices=["float32", "bfloat16"],
                   help="decoder message precision (bfloat16 halves the decode state)")
    w.add_argument("--crc", default=None,
                   choices=["24A", "24B", "24C", "16"],
                   help="CRC-aided acceptance (TS 38.212 §5.1): attach this "
                        "CRC to each simulated code block and require "
                        "syndrome AND CRC for frame acceptance")
    w.add_argument("--bch", action="store_true",
                   help="DVB-S2 outer BCH (EN 302 307): fill the BCHFEC "
                        "parity field and require syndrome AND BCH "
                        "detection for frame acceptance")
    w.add_argument("--mod", default="bpsk",
                   choices=["bpsk", "qpsk", "8psk", "16qam", "64qam",
                            "256qam", "16apsk", "32apsk"],
                   help="constellation (NR QAM per TS 38.211 §5.1; DVB-S2 "
                        "PSK/APSK geometry per EN 302 307 §5.4); soft "
                        "demapping feeds the decoder")
    w.add_argument("--demap", default="maxlog", choices=["maxlog", "exact"],
                   help="soft-demapper flavor for --mod != bpsk")
    w.add_argument("--id-outer", type=int, default=0, dest="id_outer",
                   help="BICM-ID: demapper<->decoder extrinsic exchanges "
                        "after the first pass (needs --mod != bpsk; pays "
                        "off on non-Gray labelings — see ops/bicm_id.py)")
    w.add_argument("--snr-shards", type=int, default=1,
                   help="shard the SNR grid over this many mesh shards "
                        "(must divide the device count): groups of N SNR "
                        "points run simultaneously on an (snr x data) mesh "
                        "— the BASELINE config-5 layout")
    w.add_argument("--target-errors", type=int, default=100)
    w.add_argument("--max-frames", type=int, default=1_000_000)
    w.add_argument("--seed", type=int, default=0)
    w.add_argument("--checkpoint", default=None)
    w.add_argument("--out", default=None, help=".csv or .json report path")
    w.add_argument("-v", "--verbose", action="store_true")
    w.set_defaults(fn=cmd_waterfall)

    b = sub.add_parser("bench", help="headline throughput benchmark")
    b.set_defaults(fn=cmd_bench)

    th = sub.add_parser(
        "threshold",
        help="PEXIT decoding threshold (density evolution on the protograph)"
    )
    th.add_argument("--family", default="wimax",
                    choices=["wimax", "wifi", "regular", "nr", "dvbs2",
                             "rs_ldpc"])
    th.add_argument("--n", type=int, default=576)
    th.add_argument("--rate", default="1/2")
    th.add_argument("--z", type=int, default=384, help="NR lifting size")
    th.add_argument("--bg", type=int, default=1, help="NR base graph")
    th.set_defaults(fn=cmd_threshold)

    d = sub.add_parser(
        "design",
        help="PEXIT-guided threshold descent on a base graph / IRA profile"
    )
    d.add_argument("--family", default="nr", choices=["nr", "dvbs2"])
    d.add_argument("--bg", type=int, default=2, help="NR base graph")
    d.add_argument("--n", type=int, default=16200)
    d.add_argument("--rate", default="1/2")
    d.add_argument("--steps", type=int, default=300)
    d.add_argument("--seed", type=int, default=0)
    d.add_argument("--out", default=None,
                   help=".npy (nr support) / text table (dvbs2 addresses)")
    d.set_defaults(fn=cmd_design)

    pr = sub.add_parser(
        "probe",
        help="error-impulse floor probe (d_min bound, trapped-set "
             "fingerprint) on the production decode path"
    )
    pr.add_argument("--family", default="wimax",
                    choices=["wimax", "wifi", "regular", "nr", "dvbs2",
                             "rs_ldpc"])
    pr.add_argument("--n", type=int, default=576)
    pr.add_argument("--rate", default="1/2")
    pr.add_argument("--z", type=int, default=384, help="NR lifting size")
    pr.add_argument("--bg", type=int, default=1, help="NR base graph")
    pr.add_argument("--amplitude", type=float, default=8.0)
    pr.add_argument("--max-pairs", type=int, default=2048)
    pr.set_defaults(fn=cmd_probe)
    return p


def main(argv=None) -> int:
    from .utils.runtime import setup_compile_cache

    args = build_parser().parse_args(argv)
    setup_compile_cache()
    if args.platform or args.cpu_devices:
        import jax

        if args.platform:
            jax.config.update("jax_platforms", args.platform)
        if args.cpu_devices:
            jax.config.update("jax_num_cpu_devices", args.cpu_devices)
    return args.fn(args)


if __name__ == "__main__":
    raise SystemExit(main())
