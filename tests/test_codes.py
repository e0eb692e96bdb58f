"""Code-construction tests: QC expansion, weights, structure invariants.

Checks the construction rules the reference implements in
``Coder::initCheckMatrix`` (``MyLdpc.cpp:52-135``): z = n/24, shift scaling
``p*z//96`` (``p % z`` for rate 2/3A), block (i,j) shift s placing ones at
(i*z+r, j*z+(r+s)%z).
"""
import numpy as np
import pytest

from myldpccppapi.codes import wimax, wifi
from myldpccppapi.codes.base_matrices import WIMAX_SEEDS
from myldpccppapi.codes.gf2 import gf2_inv, gf2_matmul, gf2_rank

ALL_WIMAX_RATES = sorted(WIMAX_SEEDS)


@pytest.mark.parametrize("rate", ALL_WIMAX_RATES)
@pytest.mark.parametrize("n", [576, 1152, 2304])
def test_wimax_construction(rate, n):
    code = wimax(n, rate)
    assert code.n == n
    assert code.z == n // 24
    num, den = rate[0], rate[2]
    assert code.k == n * int(num) // int(den)
    h = code.h_dense()
    assert h.shape == (code.m, code.n)
    # every row/col weight equals its base row/col degree (blocks are permutations)
    assert (h.sum(1).reshape(code.m_b, code.z) == code.row_degrees[:, None]).all()
    assert (h.sum(0).reshape(code.n_b, code.z) == code.col_degrees[:, None]).all()
    # edge count
    assert h.sum() == code.num_edges


def test_wimax_shift_rule_spot_checks():
    # rate 1/2, z=24: seed entry (0,1)=94 -> shift 94*24//96 = 23
    code = wimax(576, "1/2")
    assert code.base[0, 1] == 23
    h = code.h_dense()
    z = 24
    # block (0,1): one at (r, z + (r+23)%z)
    for r in [0, 5, 23]:
        assert h[r, z + (r + 23) % z]
    # rate 2/3A uses p % z
    code_a = wimax(576, "2/3A")
    assert code_a.base[0, 4] == 2 % 24


def test_wimax_block_structure_roundtrip():
    code = wimax(576, "3/4B")
    rows, cols = code.h_coo()
    h = code.h_dense()
    h2 = np.zeros_like(h)
    h2[rows, cols] = True
    assert (h == h2).all()
    # row-major edge order: rows non-decreasing, cols ascending within a row
    assert (np.diff(rows) >= 0).all()
    same_row = np.diff(rows) == 0
    assert (np.diff(cols)[same_row] > 0).all()


def test_wifi_construction():
    code = wifi(1944, "5/6")
    assert (code.n, code.k, code.z) == (1944, 1620, 81)
    code2 = wifi(1944, "1/2")
    assert (code2.n, code2.k) == (1944, 972)
    # parity part of H must be full rank (else the code rate would be wrong)
    for c in (code, code2):
        h = c.h_dense()
        assert gf2_rank(h[:, c.k:]) == c.m


def test_wifi_full_table_set():
    """All 12 Annex tables: dimensions, shift ranges, the standard's
    dual-diagonal parity structure, and full-rank parity (every table
    encodes at the nominal rate)."""
    import numpy as np

    from myldpccppapi.codes.base_matrices import WIFI_SEEDS

    assert len(WIFI_SEEDS) == 12
    for n in (648, 1296, 1944):
        z = n // 24
        for rate, m_b in (("1/2", 12), ("2/3", 8), ("3/4", 6), ("5/6", 4)):
            code = wifi(n, rate)
            assert (code.z, code.m_b, code.n_b) == (z, m_b, 24)
            base = code.base
            assert base.max() < z and base.min() >= -1
            kb = 24 - m_b
            # first parity column: entries at rows 0 / middle / last with
            # shift 1 / 0 / 1 (the 802.11n differential-encoding column)
            col = base[:, kb]
            nz = np.nonzero(col >= 0)[0]
            assert nz[0] == 0 and nz[-1] == m_b - 1 and len(nz) == 3
            assert col[0] == 1 and col[nz[1]] == 0 and col[m_b - 1] == 1
            # dual-diagonal staircase on the remaining parity columns
            for j in range(m_b - 1):
                pc = base[:, kb + 1 + j]
                rows = set(np.nonzero(pc >= 0)[0])
                assert rows == {j, j + 1} and pc[j] == 0 and pc[j + 1] == 0
            assert gf2_rank(code.h_dense()[:, code.k:]) == code.m


def test_gf2_inverse():
    rng = np.random.default_rng(0)
    for n in [1, 2, 17, 64]:
        while True:
            m = rng.integers(0, 2, size=(n, n)).astype(np.bool_)
            if gf2_rank(m) == n:
                break
        inv = gf2_inv(m)
        assert (gf2_matmul(m, inv) == np.eye(n, dtype=bool)).all()


def test_gf2_singular_raises():
    m = np.zeros((4, 4), dtype=np.bool_)
    with pytest.raises(np.linalg.LinAlgError):
        gf2_inv(m)


@pytest.mark.slow
def test_wifi_roundtrip_each_length():
    """One end-to-end encode->AWGN->decode per 802.11n length."""
    import jax
    import jax.numpy as jnp

    from myldpccppapi import Decoder, DecoderConfig, Encoder
    from myldpccppapi.codes import encode_numpy
    from myldpccppapi.ops.channel import transmit

    rng = np.random.default_rng(0)
    for (n, rate) in ((648, "3/4"), (1296, "2/3"), (1944, "3/4")):
        code = wifi(n, rate)
        enc = Encoder(code)
        u = rng.integers(0, 2, size=(8, code.k), dtype=np.uint8)
        c = encode_numpy(enc.mats, u)
        assert code.syndrome(c).sum() == 0
        llr, _ = transmit(jax.random.PRNGKey(1), jnp.asarray(c), snr_db=7.0)
        dec = Decoder(code, DecoderConfig(schedule="layered",
                                          normalization=0.75))
        res = dec(llr)
        assert np.asarray(res.converged).all()
        assert (np.asarray(res.bits)[:, : code.k] == u).all()


def test_qc_syndrome_matches_dense():
    """Block-sparse syndrome == dense H @ c mod 2, including multi-edge
    blocks and masked wrap rows (DVB-S2 short frame exercises both)."""
    import numpy as np

    from myldpccppapi.codes.dvbs2 import dvbs2_ira_qc
    from myldpccppapi.codes.wimax import wimax

    rng = np.random.default_rng(7)
    for code in (wimax(576, "3/4B"), dvbs2_ira_qc(16200, "8/9")):
        bits = rng.integers(0, 2, size=(3, code.n), dtype=np.uint8)
        dense = (bits.astype(np.int64) @ code.h_dense().astype(np.int64).T) % 2
        assert (code.syndrome(bits) == dense).all()
