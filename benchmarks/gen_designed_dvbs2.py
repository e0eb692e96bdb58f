"""Freeze PEXIT-designed DVB-S2 address tables into codes/dvbs2_designed.py.

Usage: python benchmarks/gen_designed_dvbs2.py 16200:1/2=/tmp/dvb_r12.npy ...

Each .npy holds the optimized info-part multiplicity matrix from
codes/design.optimize_dvbs2_profile; this realizes it as a girth-aware
EN 302 307-style address table (codes/design.realize_dvbs2_addresses) and
freezes the winner with its PEXIT threshold.
"""
import pathlib
import sys
import warnings

import numpy as np

sys.path.insert(0, str(pathlib.Path(__file__).resolve().parent.parent))

from myldpccppapi.codes.design import (  # noqa: E402
    _dvbs2_dims, realize_dvbs2_addresses,
)
from myldpccppapi.codes.dvbs2 import dvbs2_ira_qc  # noqa: E402
from myldpccppapi.codes.pexit import threshold_ebn0  # noqa: E402

OUT = (pathlib.Path(__file__).resolve().parent.parent
       / "myldpccppapi" / "codes" / "dvbs2_designed.py")

HEADER = '''\
"""PEXIT-designed DVB-S2 synthetic address tables (generated data).

Produced by :func:`..design.optimize_dvbs2_profile` (greedy threshold
descent on the IRA info-part multiplicity matrix, accumulator fixed) +
:func:`..design.realize_dvbs2_addresses` (girth-aware address drawing),
frozen by ``benchmarks/gen_designed_dvbs2.py``.  They replace the
profile-recall synthetic tables for the (n, rate) pairs whose recalled
profiles measured far from capacity (BENCH_NOTES round 4); the bit-true
Annex B/C tables remain a drop-in via ``dvbs2(addresses=...)`` exactly as
before (PROVENANCE.md).  Thresholds below are Eb/N0 (dB) from
codes/pexit.py.
"""

__all__ = ["DESIGNED_ADDRESSES", "DESIGNED_THRESHOLD_DB"]

'''


def freeze(spec):
    tables = {}
    thrs = {}
    for key, path in spec.items():
        n_s, rate = key.split(":")
        n = int(n_s)
        bi = np.load(path)
        with warnings.catch_warnings():
            warnings.simplefilter("error")  # demand a girth-6 realization
            addrs = None
            for seed in range(8):
                try:
                    addrs = realize_dvbs2_addresses(bi, n, rate, seed=seed)
                    break
                except UserWarning:
                    continue
        if addrs is None:
            raise SystemExit(f"{key}: no girth-6 realization in 8 seed sets")
        code = dvbs2_ira_qc(n, rate, addrs)
        thr = threshold_ebn0(code)
        tables[(n, rate)] = addrs
        thrs[(n, rate)] = round(float(thr), 3)
        print(f"{key}: threshold {thr:.3f} dB, "
              f"{sum(len(a) for a in addrs)} addresses")

    with open(OUT, "w") as f:
        f.write(HEADER)
        f.write("DESIGNED_ADDRESSES = {\n")
        for (n, rate), addrs in sorted(tables.items()):
            f.write(f"    ({n}, {rate!r}): (\n")
            for a in addrs:
                f.write(f"        {a!r},\n")
            f.write("    ),\n")
        f.write("}\n\n")
        f.write(f"DESIGNED_THRESHOLD_DB = {thrs!r}\n")
    print("wrote", OUT)


if __name__ == "__main__":
    freeze(dict(a.split("=", 1) for a in sys.argv[1:]))
