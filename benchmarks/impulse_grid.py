"""Error-impulse probe across the shipped default codes (on chip).

Records per code: the smallest codeword weight an impulse broke through to
(an upper bound on d_min), breach/trapped counts, and the implicated base
columns — the floor-structure fingerprint next to each family's measured
waterfall.  Probes are batched decodes on the production kernels; the
whole grid is a few thousand frames.
"""
import json
import os
import sys

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

RESULTS = os.path.join(os.path.dirname(os.path.abspath(__file__)),
                       "results.jsonl")


def record(row):
    with open(RESULTS, "a") as f:
        f.write(json.dumps(row) + "\n")
    print(json.dumps(row), flush=True)


def main():
    from myldpccppapi.codes import dvbs2, nr_code, rs_ldpc, wifi, wimax
    from myldpccppapi.ops.impulse import impulse_probe

    cases = [
        ("wimax_576_1/2", wimax(576, "1/2")),
        ("wimax_576_3/4B", wimax(576, "3/4B")),
        ("wifi_648_1/2", wifi(648, "1/2")),
        ("wifi_1944_5/6", wifi(1944, "5/6")),
        ("nr_bg1_z384", nr_code(z=384, bg=1)),
        ("nr_bg2_z384", nr_code(z=384, bg=2)),
        ("dvbs2_16200_1/2", dvbs2(16200, "1/2")),
        ("dvbs2_16200_1/3", dvbs2(16200, "1/3")),
        ("dvbs2_64800_1/2", dvbs2(64800, "1/2")),
        ("rs_ldpc_2048", rs_ldpc(s=6)),
    ]
    for name, code in cases:
        r = impulse_probe(code, max_pair_patterns=2048)
        record({
            "config": "impulse_probe", "code": name,
            "min_weight": r.min_weight,
            "support_cols": (r.support_cols.tolist()
                             if r.support_cols is not None else None),
            "breaches": r.breaches, "trapped": len(r.trapped),
            "probes": r.probes,
        })


if __name__ == "__main__":
    main()
