"""Multi-PROCESS validation of the N-host campaign path (BASELINE config 5).

The sharded campaign step (`parallel/sim.py:make_sharded_campaign_step`)
is the framework's answer to running a BER/FER waterfall "batch-sharded
across N>=2 hosts with psum'd frame-error stats".  The multi-host
*software* path — separate processes, `jax.distributed.initialize`, a
global mesh spanning devices the local process cannot address, and
cross-process collectives over a network transport (Gloo/TCP here) — is
exercised for real with N CPU processes on one box.  Every worker is pinned
to the CPU backend: a JAX process reserves most of a GPU's memory when it
first uses it, so processes sharing one card would fail for want of memory.  That is strictly stronger than the
single-process virtual mesh in `benchmarks/scaling.py`: the psum really
crosses process boundaries over TCP.

Correctness oracle: the sharded step folds each device's GLOBAL mesh
position into the PRNG key (`sim.py:local_step`), so the global computation
depends only on the global mesh — not on how processes partition it.  A
2-process x 4-device run must therefore produce BIT-IDENTICAL statistics to
a 1-process x 8-device run.  This harness checks exactly that, and times
the cross-process step to measure the collective's overhead directly.

Usage (parent launches workers, compares against single-process)::

    python benchmarks/multihost.py --nproc 2 --local-devices 4 \
        --family wimax --n 576 --rate 3/4B --batch-per-device 32 --snr 4,5

Reference analogue: none — the reference is single-process, single-GPU
(SURVEY.md §2.3); this subsystem is new capability required by BASELINE.
"""
from __future__ import annotations

import argparse
import json
import os
import socket
import subprocess
import sys
import time

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, REPO)


def _free_port() -> int:
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def _build_code(args):
    if args.family == "wimax":
        from myldpccppapi import wimax
        return wimax(args.n, args.rate)
    if args.family == "wifi":
        from myldpccppapi import wifi
        return wifi(args.n, args.rate)
    if args.family == "nr":
        from myldpccppapi.codes.nr import nr_code
        return nr_code(z=args.z, bg=args.bg)
    if args.family == "dvbs2":
        from myldpccppapi.codes.dvbs2 import dvbs2_ira_qc
        return dvbs2_ira_qc(args.n, args.rate)
    raise ValueError(f"unknown family {args.family}")


def worker(args) -> dict:
    """One process of the N-process campaign.  Returns stats dict (rank 0)."""
    import jax

    # pinned to the CPU (module docstring): one process per card at most
    jax.config.update("jax_platforms", "cpu")
    jax.config.update("jax_num_cpu_devices", args.local_devices)
    if args.nproc > 1:
        jax.distributed.initialize(
            coordinator_address=f"127.0.0.1:{args.port}",
            num_processes=args.nproc,
            process_id=args.proc,
        )
    import jax.numpy as jnp
    import numpy as np

    from myldpccppapi import DecoderConfig
    from myldpccppapi.parallel import make_mesh, make_sharded_campaign_step

    code = _build_code(args)
    cfg = DecoderConfig(schedule=args.schedule, normalization=args.norm,
                        max_iters=args.max_iters)
    snr = jnp.asarray([float(s) for s in args.snr.split(",")], jnp.float32)
    devs = jax.devices()  # GLOBAL device list, identical order on all procs
    mesh = make_mesh((len(devs),), ("data",), devices=devs)
    step = jax.jit(make_sharded_campaign_step(
        code, cfg, mesh, batch_per_device=args.batch_per_device,
        num_snr=snr.shape[0],
    ))

    def fetch(stats):
        # outputs are data-axis-replicated; read this process's local shard
        return {k: np.asarray(getattr(stats, k).addressable_data(0)).tolist()
                for k in stats._fields}

    out = step(jax.random.PRNGKey(args.seed), snr)  # compile + warm
    _ = fetch(out)
    t0 = time.perf_counter()
    for i in range(args.repeats):
        out = step(jax.random.PRNGKey(args.seed + 1 + i), snr)
    got = fetch(out)  # host readback = the only true sync
    dt = (time.perf_counter() - t0) / args.repeats
    frames_per_step = int(sum(got["frames"]))
    result = {
        "nproc": args.nproc,
        "proc": args.proc,
        "global_devices": len(devs),
        "local_devices": args.local_devices,
        "snr_db": [float(s) for s in args.snr.split(",")],
        "frames_per_step": frames_per_step,
        "step_s": dt,
        "frames_per_s": frames_per_step / dt,
        "stats_last_step": got,
    }
    print("MULTIHOST_RESULT " + json.dumps(result), flush=True)
    return result


def launch(args) -> dict:
    """Parent: run the N-process campaign, then the 1-process control with
    the SAME global device count, and verify bit-identical statistics."""
    port = _free_port()
    base = [sys.executable, os.path.abspath(__file__), "--worker",
            "--port", str(port)]
    passthrough = ["--family", args.family, "--n", str(args.n),
                   "--rate", args.rate, "--z", str(args.z),
                   "--bg", str(args.bg), "--schedule", args.schedule,
                   "--norm", str(args.norm), "--max-iters", str(args.max_iters),
                   "--batch-per-device", str(args.batch_per_device),
                   "--snr=" + args.snr, "--seed", str(args.seed),
                   "--repeats", str(args.repeats)]

    def run_procs(nproc: int, local_devices: int):
        procs = []
        for p in range(nproc):
            cmd = base + passthrough + [
                "--nproc", str(nproc), "--proc", str(p),
                "--local-devices", str(local_devices)]
            procs.append(subprocess.Popen(
                cmd, stdout=subprocess.PIPE, stderr=subprocess.DEVNULL,
                text=True, cwd=REPO))
        outs = [p.communicate(timeout=args.timeout)[0] for p in procs]
        for p, o in zip(procs, outs):
            if p.returncode != 0:
                raise RuntimeError(f"worker rc={p.returncode}\n{o[-2000:]}")
        results = []
        for o in outs:
            for line in o.splitlines():
                if line.startswith("MULTIHOST_RESULT "):
                    results.append(json.loads(line[len("MULTIHOST_RESULT "):]))
        return results

    glob_dev = args.nproc * args.local_devices
    if args.partitions:
        # Partition matrix: every way of cutting the SAME global mesh into
        # processes must produce bit-identical statistics (the step folds
        # only GLOBAL mesh position into the PRNG key).  "1x8,2x4,4x2"
        # runs all three and cross-checks.
        parts = []
        for spec in args.partitions.split(","):
            np_, ld = (int(x) for x in spec.lower().split("x"))
            if np_ * ld != glob_dev:
                raise SystemExit(
                    f"partition {spec} has {np_ * ld} devices, expected "
                    f"{glob_dev} (=nproc*local_devices)")
            parts.append((spec, np_, ld))
        runs = {spec: run_procs(np_, ld) for spec, np_, ld in parts}
        base_spec = parts[0][0]
        base_stats = runs[base_spec][0]["stats_last_step"]
        matrix_identical = {
            spec: all(r["stats_last_step"] == base_stats for r in rs)
            for spec, rs in runs.items()
        }
        report = {
            "harness": "multiprocess_gloo_matrix",
            "global_devices": glob_dev,
            "partitions": list(matrix_identical),
            "stats_bit_identical_across_partitions": all(
                matrix_identical.values()),
            "per_partition_identical": matrix_identical,
            "step_s": {spec: max(r["step_s"] for r in rs)
                       for spec, rs in runs.items()},
            "frames_per_step": runs[base_spec][0]["frames_per_step"],
        }
        print(json.dumps(report))
        return report
    t0 = time.time()
    multi = run_procs(args.nproc, args.local_devices)
    multi_wall = time.time() - t0
    single = run_procs(1, glob_dev)
    identical = all(r["stats_last_step"] == single[0]["stats_last_step"]
                    for r in multi)
    report = {
        "harness": "multiprocess_gloo",
        "nproc": args.nproc,
        "global_devices": glob_dev,
        "stats_bit_identical_to_single_process": identical,
        "all_ranks_agree": all(
            r["stats_last_step"] == multi[0]["stats_last_step"] for r in multi),
        "multi_step_s": max(r["step_s"] for r in multi),
        "single_step_s": single[0]["step_s"],
        "cross_process_overhead_s": max(r["step_s"] for r in multi)
                                    - single[0]["step_s"],
        "frames_per_step": multi[0]["frames_per_step"],
        "multi_wall_s": multi_wall,
        "note": ("same global device count both ways: measures the pure "
                 "cost of crossing process boundaries (Gloo/TCP psum + "
                 "multi-process dispatch); cores are shared so this is an "
                 "upper bound on the collective's cost"),
    }
    print(json.dumps(report))
    return report


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__)
    ap.add_argument("--worker", action="store_true")
    ap.add_argument("--nproc", type=int, default=2)
    ap.add_argument("--proc", type=int, default=0)
    ap.add_argument("--local-devices", type=int, default=4)
    ap.add_argument("--port", type=int, default=0)
    ap.add_argument("--family", default="wimax")
    ap.add_argument("--n", type=int, default=576)
    ap.add_argument("--rate", default="3/4B")
    ap.add_argument("--z", type=int, default=64)
    ap.add_argument("--bg", type=int, default=1)
    ap.add_argument("--schedule", default="layered")
    ap.add_argument("--norm", type=float, default=0.75)
    ap.add_argument("--max-iters", type=int, default=40)
    ap.add_argument("--batch-per-device", type=int, default=32)
    ap.add_argument("--snr", default="4.0,5.0")
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--repeats", type=int, default=3)
    ap.add_argument("--timeout", type=float, default=600.0)
    ap.add_argument("--partitions", default="",
                    help='partition matrix over ONE global device count, '
                         'e.g. "1x8,2x4,4x2" (nproc x local_devices); all '
                         'must be bit-identical')
    args = ap.parse_args(argv)
    if args.worker:
        worker(args)
    else:
        report = launch(args)
        if "stats_bit_identical_across_partitions" in report:
            return 0 if report["stats_bit_identical_across_partitions"] else 1
        return 0 if (report["stats_bit_identical_to_single_process"]
                     and report["all_ranks_agree"]) else 1
    return 0


if __name__ == "__main__":
    sys.exit(main())
