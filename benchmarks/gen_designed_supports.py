"""Regenerate myldpccppapi/codes/nr_designed.py from optimizer outputs.

Usage: python benchmarks/gen_designed_supports.py bg2=/tmp/bg2_opt.npy [bg1=...]

Reproducibility: the supports come from codes/design.optimize_nr_support
(deterministic given bg/steps/seed/start); this script just freezes the
winner as data with its PEXIT threshold, so the package does not pay the
multi-minute search at import time.
"""
import pathlib
import sys

import numpy as np

sys.path.insert(0, str(pathlib.Path(__file__).resolve().parent.parent))

from myldpccppapi.codes.design import _threshold, _valid  # noqa: E402

OUT = (pathlib.Path(__file__).resolve().parent.parent
       / "myldpccppapi" / "codes" / "nr_designed.py")

HEADER = '''\
"""PEXIT-designed synthetic NR base-graph supports (generated data).

Produced by :func:`..design.optimize_nr_support` (greedy threshold descent
under the TS 38.212 structural constraints) and frozen here by
``benchmarks/gen_designed_supports.py``; thresholds below are Eb/N0 (dB) at
the mother rate with the 2Z front puncture (codes/pexit.py).  These replace
the profile-recall synthetic supports where measurement confirmed the
design gain (BENCH_NOTES round 4); the bit-true standard tables remain a
drop-in via ``nr_code(table=parse_bg_table(...))`` exactly as before
(PROVENANCE.md).

Format: ``DESIGNED_SUPPORT[bg]`` is a tuple of per-row tuples of column
indices over the mutable region (systematic + core-parity columns); the
core staircase and identity extension columns are implied by the
structure and added by ``nr_base_graph``.
"""
import numpy as np

__all__ = ["DESIGNED_SUPPORT", "DESIGNED_THRESHOLD_DB", "designed_support"]

'''


def freeze(name_to_path):
    rows_repr = {}
    thr_repr = {}
    shapes = {}
    for key, path in name_to_path.items():
        bg = int(key[-1])
        b = np.load(path)
        assert _valid(b, bg), f"support in {path} violates constraints"
        thr = _threshold(b.astype(int), bg, -3.0, 10.0, 0.01)
        rows = tuple(tuple(int(j) for j in np.flatnonzero(r)) for r in b)
        rows_repr[bg] = rows
        thr_repr[bg] = round(float(thr), 3)
        shapes[bg] = b.shape
        print(f"BG{bg}: threshold {thr:.3f} dB, {b.sum()} edges")

    with open(OUT, "w") as f:
        f.write(HEADER)
        f.write("DESIGNED_SUPPORT = {\n")
        for bg, rows in sorted(rows_repr.items()):
            f.write(f"    {bg}: (\n")
            for r in rows:
                f.write(f"        {r!r},\n")
            f.write("    ),\n")
        f.write("}\n\n")
        f.write(f"DESIGNED_THRESHOLD_DB = {thr_repr!r}\n\n")
        f.write("_SHAPES = " + repr({k: tuple(v) for k, v in shapes.items()})
                + "\n\n\n")
        f.write('''def designed_support(bg: int) -> np.ndarray:
    """Boolean [m_b, n_b] support; raises KeyError for undesigned graphs."""
    rows = DESIGNED_SUPPORT[bg]
    m_b, n_b = _SHAPES[bg]
    b = np.zeros((m_b, n_b), dtype=bool)
    for i, cols in enumerate(rows):
        b[i, list(cols)] = True
    return b
''')
    print("wrote", OUT)


if __name__ == "__main__":
    freeze(dict(a.split("=", 1) for a in sys.argv[1:]))
