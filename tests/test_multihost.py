"""Multi-process (N-host software path) campaign validation.

Spawns REAL separate Python processes that form one JAX distributed job
(`jax.distributed.initialize`, CPU backend) and run the sharded campaign
step over a global mesh whose devices span process boundaries — the psum
of the SimStats crosses processes over Gloo/TCP, the software shape of the
BASELINE config-5 "N>=2 hosts with psum'd frame-error stats" requirement.

The oracle is exact: the step folds each device's GLOBAL mesh position
into the PRNG key, so statistics must be BIT-IDENTICAL no matter how the
same global mesh is partitioned into processes (2x2 vs 1x4 here).  The
workers stay on the CPU backend whatever the machine has: one process per
card at most.
"""
import pytest
import json
import os
import subprocess
import sys

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
SCRIPT = os.path.join(REPO, "benchmarks", "multihost.py")


@pytest.mark.slow
def test_two_process_campaign_bit_identical_to_single():
    out = subprocess.run(
        [sys.executable, SCRIPT, "--nproc", "2", "--local-devices", "2",
         "--batch-per-device", "8", "--snr", "4.0", "--repeats", "1",
         "--max-iters", "10", "--timeout", "240"],
        capture_output=True, text=True, timeout=300, cwd=REPO,
    )
    assert out.returncode == 0, out.stdout[-2000:] + out.stderr[-2000:]
    report = json.loads(out.stdout.strip().splitlines()[-1])
    assert report["stats_bit_identical_to_single_process"] is True
    assert report["all_ranks_agree"] is True
    assert report["global_devices"] == 4


@pytest.mark.slow
def test_four_process_partition_matrix_bit_identical():
    """The 4-process partition matrix (VERDICT r4 item 4): one 8-device
    global mesh cut as 1x8 / 2x4 / 4x2 processes must produce bit-identical
    campaign statistics — the step's PRNG depends only on GLOBAL mesh
    position, so process boundaries (and the Gloo/TCP psum they force)
    must be invisible in the numbers."""
    out = subprocess.run(
        [sys.executable, SCRIPT, "--nproc", "4", "--local-devices", "2",
         "--partitions", "1x8,2x4,4x2",
         "--batch-per-device", "4", "--snr", "4.0", "--repeats", "1",
         "--max-iters", "8", "--timeout", "420"],
        capture_output=True, text=True, timeout=600, cwd=REPO,
    )
    assert out.returncode == 0, out.stdout[-2000:] + out.stderr[-2000:]
    report = json.loads(out.stdout.strip().splitlines()[-1])
    assert report["stats_bit_identical_across_partitions"] is True
    assert sorted(report["partitions"]) == ["1x8", "2x4", "4x2"]


@pytest.mark.slow
def test_two_process_campaign_masked_circulant_dvbs2():
    """The config-5 hard shape across REAL process boundaries: the
    masked-circulant / multi-edge DVB-S2 16200 campaign step must produce
    bit-identical statistics when its global mesh is split across two
    jax.distributed processes (a sharding bug specific to the masked
    writeback path would be invisible to the wimax-only runs)."""
    out = subprocess.run(
        [sys.executable, SCRIPT, "--nproc", "2", "--local-devices", "2",
         "--family", "dvbs2", "--n", "16200", "--rate", "1/2",
         "--batch-per-device", "2", "--snr", "2.0", "--repeats", "1",
         "--max-iters", "4", "--timeout", "420"],
        capture_output=True, text=True, timeout=600, cwd=REPO,
    )
    assert out.returncode == 0, out.stdout[-2000:] + out.stderr[-2000:]
    report = json.loads(out.stdout.strip().splitlines()[-1])
    assert report["stats_bit_identical_to_single_process"] is True
    assert report["all_ranks_agree"] is True
