"""BICM-ID: iterative demapping <-> decoding (turbo equalization shape).

The classic receive chain demaps once and decodes (``sim.py``; reference
analogue: the one-shot channel LLR init, ``decodeCL.c:3-22``).  With a
non-Gray labeling the demapper leaves mutual information on the table
that decoder feedback can recover: BICM-ID feeds the decoder's extrinsic
LLRs back as the demapper's a priori and re-decodes, converging like a
serially concatenated turbo scheme (Li & Ritcey 1997; ten Brink's EXIT
analysis).  The reference has no analogue; the decoder's latched
posterior output (``DecoderConfig.soft_output``) supplies the feedback.

Design notes:

* the whole loop is jittable: a fixed ``n_outer`` Python loop unrolls
  into one XLA program (demap is fused elementwise work, decode is the
  jnp soft-output path), so the loop adds ZERO host round-trips;
* extrinsics are exchanged, not APPs: the demapper returns APP and the
  loop subtracts the fed prior; the decoder's extrinsic is posterior
  minus its channel input (both subtractions fuse into the neighbors);
* an optional interleaver pair maps between codeword bit order and
  mapper bit order (EN 302 307 §5.3.3 column interleaver; identity
  default), as extrinsic feedback must traverse it in both directions.

Gray-labeled constellations gain ~nothing from ID (their EXIT curve is
flat — the measured result, not a defect); the win is on non-Gray /
set-partitioned labelings.  ``benchmarks/bicm_id_bench.py`` measures
both on chip.
"""
from __future__ import annotations

from typing import Callable, Optional

import jax
import jax.numpy as jnp

from ..utils.config import DecoderConfig
from .modulation import Modulation, demap_llr

__all__ = ["bicm_id_receive", "make_bicm_id_receive"]


def make_bicm_id_receive(
    code,
    cfg: DecoderConfig,
    mod: Modulation,
    n_outer: int = 2,
    method: str = "maxlog",
    extrinsic_scale: float = 1.0,
    deinterleave: Optional[Callable] = None,
    interleave: Optional[Callable] = None,
):
    """Build ``receive(y, n0) -> DecodeResult`` running ``n_outer``
    demapper<->decoder extrinsic exchanges after the initial pass.

    ``cfg`` must not pre-set ``soft_output`` (the loop manages it: soft
    for the feedback passes, the caller's choice for the last).
    ``extrinsic_scale``: damping on the decoder->demapper feedback
    (1.0 = none; ~0.75 helps max-log loops at low SNR).
    ``deinterleave``/``interleave``: mapper-order -> codeword-order LLR
    permutation and its inverse (identity when None).
    """
    if cfg.soft_output:
        raise ValueError("leave soft_output unset; the loop manages it")
    if n_outer < 0:
        raise ValueError(f"n_outer must be >= 0, got {n_outer}")
    from ..decoder import Decoder

    import dataclasses

    dec_soft = Decoder(code, dataclasses.replace(cfg, soft_output=True))
    dec_last = Decoder(code, cfg)
    de_il = deinterleave if deinterleave is not None else (lambda x: x)
    il = interleave if interleave is not None else (lambda x: x)

    def receive(y: jax.Array, n0) -> "DecodeResult":
        app = demap_llr(y, n0, mod, method)          # first pass: no prior
        llr_in = de_il(app)                          # codeword order
        for t in range(n_outer):
            res = dec_soft(llr_in)
            dec_ext = (res.posteriors - llr_in) * extrinsic_scale
            prior = il(dec_ext)                      # mapper order
            app = demap_llr(y, n0, mod, method, prior=prior)
            llr_in = de_il(app - prior)              # demapper extrinsic
        return dec_last(llr_in)

    return receive


def bicm_id_receive(code, cfg, y, n0, mod, n_outer=2, method="maxlog",
                    extrinsic_scale=1.0, deinterleave=None, interleave=None):
    """One-call form of :func:`make_bicm_id_receive` (builds decoders per
    call — prefer the factory inside jit loops)."""
    fn = make_bicm_id_receive(code, cfg, mod, n_outer, method,
                              extrinsic_scale, deinterleave, interleave)
    return fn(y, n0)
