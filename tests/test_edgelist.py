"""Generic edge-list decoder: parity vs the QC-roll path on the same H.

The edge-list path serves non-QC codes (DVB-S2, random constructions); its
correctness oracle is the QC decoder run on an identical parity-check
matrix.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest

from myldpccppapi import Decoder, DecoderConfig, Encoder, wimax
from myldpccppapi.codes import encode_numpy, regular
from myldpccppapi.ops.bp import decode_qc
from myldpccppapi.ops.bp_edgelist import build_edge_index, decode_edgelist
from myldpccppapi.ops.channel import transmit


def _case(code, batch, snr_db, seed=0):
    enc = Encoder(code)
    rng = np.random.default_rng(seed)
    u = rng.integers(0, 2, size=(batch, enc.k), dtype=np.uint8)
    c = np.asarray(enc(jnp.asarray(u)))
    llr, _ = transmit(jax.random.PRNGKey(seed), jnp.asarray(c), snr_db=snr_db)
    return u, c, jnp.asarray(llr)


def _index(code, layered=False):
    rows, cols = code.h_coo()
    layer = np.arange(code.m) // code.z if layered else None
    return build_edge_index(rows, cols, code.n, code.m, layer)


@pytest.mark.parametrize("algorithm", ["min-sum", "sum-product"])
def test_edgelist_flooding_matches_qc(algorithm):
    """Same algebra as the QC path; converged frames must agree bit-exactly.

    Frames that hit the iteration cap follow a chaotic trajectory where
    float summation *order* (sequential block adds vs tree reductions in
    the posterior sum) legitimately diverges — those are excluded, exactly
    as two runs of the reference on different devices would disagree there.
    """
    code = wimax(576, "3/4B")
    _, _, llr = _case(code, batch=12, snr_db=5.0)
    cfg = DecoderConfig(algorithm=algorithm, schedule="flooding")
    ref = decode_qc(code, cfg, llr)
    res = decode_edgelist(_index(code), cfg, llr)
    conv = np.asarray(ref.converged)
    assert conv.sum() >= 10  # the case must be dominated by converged frames
    assert (np.asarray(res.converged) == conv).all()
    assert (np.asarray(res.bits)[conv] == np.asarray(ref.bits)[conv]).all()
    assert (np.asarray(res.iterations) == np.asarray(ref.iterations)).all()


def test_edgelist_layered_matches_qc():
    """Grouped-TDMP with one layer per z-row block must match the QC layered
    schedule on converged frames (same layer order, same update algebra)."""
    code = wimax(576, "1/2")
    _, _, llr = _case(code, batch=8, snr_db=4.0, seed=2)
    cfg = DecoderConfig(schedule="layered")
    ref = decode_qc(code, cfg, llr)
    res = decode_edgelist(_index(code, layered=True), cfg, llr)
    conv = np.asarray(ref.converged)
    assert conv.sum() >= 6
    assert (np.asarray(res.converged) == conv).all()
    assert (np.asarray(res.bits)[conv] == np.asarray(ref.bits)[conv]).all()
    assert (np.asarray(res.iterations)[conv] == np.asarray(ref.iterations)[conv]).all()


def test_decoder_facade_edgelist_impl():
    code = wimax(576, "1/2")
    u, _, llr = _case(code, batch=8, snr_db=5.0, seed=4)
    dec = Decoder(code, DecoderConfig(implementation="edgelist"))
    assert dec.implementation == "edgelist"
    res = dec(llr)
    assert np.asarray(res.converged).all()
    assert (np.asarray(dec.info_bits(res)) == u).all()


def test_regular_code_roundtrip():
    """BASELINE config 1: regular (3,6) n=648 rate-1/2, flooding SP BP."""
    code = regular(648)
    assert code.n == 648 and code.k_info == 328
    h = code.h_dense()
    assert (h.sum(1) == 6).all() and (h.sum(0) == 3).all()
    u, c, llr = _case(code, batch=16, snr_db=3.5, seed=0)
    assert code.syndrome(c).sum() == 0
    dec = Decoder(code, DecoderConfig(algorithm="sum-product", schedule="flooding"))
    res = dec(llr)
    assert np.asarray(res.converged).all()
    assert (np.asarray(dec.info_bits(res)) == u).all()
