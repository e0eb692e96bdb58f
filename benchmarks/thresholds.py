"""PEXIT decoding thresholds of every shipped code family, with capacity gaps.

Emits one results.jsonl row per code: the Gaussian-approximation BP threshold
in Eb/N0 (dB), the BPSK capacity limit at the code's (transmitted) rate, and
the gap.  Host-side analysis — runs anywhere, seconds total.

The table doubles as the analytic half of the synthetic-table provenance
argument (PROVENANCE.md): thresholds depend on the protograph only, so a
synthetic NR/DVB-S2 base matrix with the standard's degree profile shows here
exactly what its waterfall can and cannot achieve regardless of the lifting
shifts (the shifts set the error floor / girth, measured separately on chip).
"""
import json
import math
import pathlib
import sys
import time

import numpy as np

sys.path.insert(0, str(pathlib.Path(__file__).resolve().parent.parent))

from myldpccppapi.codes import (  # noqa: E402
    dvbs2, nr_code, protograph, regular, rs_ldpc, threshold_ebn0, wifi, wimax,
)

RESULTS = pathlib.Path(__file__).parent / "results.jsonl"


def bpsk_capacity_ebn0_db(rate: float, n_grid: int = 4001) -> float:
    """Eb/N0 (dB) at which binary-input AWGN capacity equals ``rate``
    (Gauss-Hermite-free numeric integration on an LLR grid)."""

    def capacity(ebn0):
        sigma = 1.0 / math.sqrt(2.0 * rate * ebn0)
        # C = 1 - E[log2(1 + e^-L)], L ~ N(2/sigma^2, 4/sigma^2)
        m, v = 2.0 / sigma**2, 4.0 / sigma**2
        x = np.linspace(m - 10 * math.sqrt(v), m + 10 * math.sqrt(v), n_grid)
        pdf = np.exp(-((x - m) ** 2) / (2 * v)) / math.sqrt(2 * math.pi * v)
        return 1.0 - np.trapezoid(np.log2(1 + np.exp(-x)) * pdf, x)

    lo, hi = 0.02, 100.0
    for _ in range(60):
        mid = math.sqrt(lo * hi)
        if capacity(mid) >= rate:
            hi = mid
        else:
            lo = mid
    return 10.0 * math.log10(hi)


def record(row):
    with open(RESULTS, "a") as f:
        f.write(json.dumps(row) + "\n")
    print(json.dumps(row))


def main():
    cases = [
        ("regular_3_6", regular(1296, row_wt=6, col_wt=3)),
        ("wimax_1/2", wimax(576, "1/2")),
        ("wimax_2/3A", wimax(576, "2/3A")),
        ("wimax_2/3B", wimax(576, "2/3B")),
        ("wimax_3/4A", wimax(576, "3/4A")),
        ("wimax_3/4B", wimax(576, "3/4B")),
        ("wimax_5/6", wimax(576, "5/6")),
        ("wifi_1/2", wifi(648, "1/2")),
        ("wifi_5/6", wifi(648, "5/6")),
        ("nr_bg1", nr_code(z=32, bg=1)),
        ("nr_bg2", nr_code(z=32, bg=2)),
        ("dvbs2_64800_1/2", dvbs2(64800, "1/2")),
        ("dvbs2_64800_3/4", dvbs2(64800, "3/4")),
        ("dvbs2_16200_1/2", dvbs2(16200, "1/2")),
        ("rs_ldpc_2048", rs_ldpc(s=6)),
    ]
    for name, code in cases:
        t0 = time.time()
        thr = threshold_ebn0(code)
        pf = getattr(code, "punctured_front", 0)
        rate = code.k_info / (code.n - pf)
        cap = bpsk_capacity_ebn0_db(rate)
        record({
            "config": "pexit_threshold",
            "code": name,
            "rate_tx": round(rate, 4),
            "threshold_ebn0_db": round(thr, 3),
            "capacity_ebn0_db": round(cap, 3),
            "gap_db": round(thr - cap, 3),
            "protograph_edges": int(protograph(code).sum()),
            "secs": round(time.time() - t0, 2),
        })


if __name__ == "__main__":
    main()
