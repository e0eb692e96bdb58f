"""PEXIT-guided base-graph design: constraint preservation, threshold
descent, and lifting/encoding of optimized supports."""
import numpy as np
import pytest

from myldpccppapi.codes.design import (
    _threshold, _valid, nr_support_default, optimize_nr_support,
)
from myldpccppapi.codes.nr import (
    _check_triangular, nr_base_graph, nr_code, triangular_encode_numpy,
)

pytestmark = pytest.mark.slow  # host-side search, ~1 min total


def test_default_support_is_valid():
    for bg in (1, 2):
        assert _valid(nr_support_default(bg), bg)


def test_optimize_improves_threshold_and_keeps_constraints():
    b0 = nr_support_default(2)
    t0 = _threshold(b0.astype(int), 2, -2.0, 10.0, 0.02)
    b, thr = optimize_nr_support(bg=2, steps=60, seed=7)
    assert _valid(b, 2)
    assert thr < t0 - 0.2
    # fixed structure untouched: identity extension diagonal intact
    m_b, n_b = b.shape
    k_b = 10
    for r in range(4, m_b):
        assert b[r, k_b + 4 + (r - 4)]


def test_optimized_support_lifts_and_encodes():
    b, thr = optimize_nr_support(bg=2, steps=40, seed=3)
    tab = nr_base_graph(2, support=b, seed=0)
    code = nr_code(z=32, bg=2, table=tab)
    _check_triangular(code)
    # threshold survives lifting (protograph is preserved)
    from myldpccppapi.codes.pexit import threshold_ebn0

    assert threshold_ebn0(code) == pytest.approx(thr, abs=0.05)
    u = np.random.default_rng(0).integers(0, 2, (4, code.k), np.uint8)
    cw = triangular_encode_numpy(code, u)
    h = code.h_dense().astype(np.int64)
    assert not ((cw.astype(np.int64) @ h.T) % 2).any()
    # girth-6 at the design lifting: no 4-cycles
    tab_full = nr_base_graph(2, support=b)
    from myldpccppapi.codes.nr import NR_ZMAX

    m_b, n_b = tab_full.shape
    for i1 in range(m_b):
        for i2 in range(i1 + 1, m_b):
            shared = [j for j in range(n_b)
                      if tab_full[i1, j] >= 0 and tab_full[i2, j] >= 0]
            for a in range(len(shared)):
                for c in range(a + 1, len(shared)):
                    j1, j2 = shared[a], shared[c]
                    d = (tab_full[i1, j1] - tab_full[i1, j2]
                         + tab_full[i2, j2] - tab_full[i2, j1]) % NR_ZMAX
                    assert d != 0


def test_bad_support_rejected():
    b = nr_support_default(2).copy()
    b[:, 0] = False  # strip the punctured column's protection
    assert not _valid(b, 2)
    with pytest.raises(AssertionError):
        optimize_nr_support(bg=2, steps=1, start=b)


def test_support_shape_checked():
    with pytest.raises(ValueError, match="support"):
        nr_base_graph(2, support=np.ones((3, 3), bool))


def test_designed_bg2_is_the_default():
    from myldpccppapi.codes.nr_designed import (
        DESIGNED_THRESHOLD_DB, designed_support,
    )
    from myldpccppapi.codes.pexit import threshold_ebn0

    # the shipped default lifts the designed support
    tab = nr_base_graph(2)
    sup = designed_support(2)
    assert ((tab >= 0) == sup).all() or (
        # structural cells are forced on even if the support omitted them
        ((tab >= 0) & ~sup).sum() == 0
    )
    code = nr_code(z=32, bg=2)
    thr = threshold_ebn0(code)
    assert thr == pytest.approx(DESIGNED_THRESHOLD_DB[2], abs=0.05)
    # and beats the legacy profile-recall synthetic by > 2 dB
    legacy = nr_code(z=32, bg=2, table=nr_base_graph(2, support="legacy"))
    assert threshold_ebn0(legacy) - thr > 2.0
    assert _valid(sup, 2)


# ---------------------------------------------------------------------------
# DVB-S2 IRA profile design
# ---------------------------------------------------------------------------

def test_dvbs2_profile_descent_and_realization():
    import warnings

    from myldpccppapi.codes.design import (
        _dvbs2_protograph, dvbs2_start_profile, optimize_dvbs2_profile,
        realize_dvbs2_addresses,
    )
    from myldpccppapi.codes.dvbs2 import dvbs2, ira_encode_numpy
    from myldpccppapi.codes.pexit import protograph, threshold_ebn0

    n, rate = 16200, "1/2"
    bi0 = dvbs2_start_profile(n, rate)
    bi, thr = optimize_dvbs2_profile(n, rate, steps=150, seed=5)
    t0 = threshold_ebn0(_dvbs2_protograph(bi0, 25, 20), rate=7200 / 16200,
                        punctured_cols=())
    assert thr < t0  # descent

    with warnings.catch_warnings():
        warnings.simplefilter("error")  # girth-6 realization must succeed
        addrs = realize_dvbs2_addresses(bi, n, rate, seed=0)
    code = dvbs2(n, rate, addresses=addrs)
    # the realized code's protograph IS the designed one
    np.testing.assert_array_equal(np.asarray(protograph(code)[:, :20]), bi)
    assert threshold_ebn0(code) == pytest.approx(thr, abs=0.05)
    # and it encodes/checks
    u = np.random.default_rng(0).integers(0, 2, (2, code.k), np.uint8)
    cw = ira_encode_numpy(code, u)
    assert code.syndrome(cw).sum() == 0


def test_designed_dvbs2_defaults():
    from myldpccppapi.codes.dvbs2 import dvbs2
    from myldpccppapi.codes.dvbs2_designed import (
        DESIGNED_ADDRESSES, DESIGNED_THRESHOLD_DB,
    )
    from myldpccppapi.codes.pexit import threshold_ebn0

    for (n, rate), thr_frozen in DESIGNED_THRESHOLD_DB.items():
        code = dvbs2(n, rate)
        assert threshold_ebn0(code) == pytest.approx(thr_frozen, abs=0.05)
        legacy = dvbs2(n, rate, addresses="legacy")
        assert threshold_ebn0(legacy) - thr_frozen > 0.9
        # diversity constraints hold in the shipped tables
        q = (n - code.k) // 360
        for g, addrs in enumerate(DESIGNED_ADDRESSES[(n, rate)]):
            residues = [a % q for a in addrs]
            assert len(set(residues)) >= 3, (n, rate, g)
            assert max(residues.count(r) for r in set(residues)) <= 2


def test_bg1_explicit_support_lifts_without_designed_seed():
    # regression: _DESIGNED_SHIFT_SEED has no BG1 entry; an explicit
    # support lift must fall back to the legacy default seed
    tab = nr_base_graph(1, support=nr_support_default(1))
    assert tab.shape == (46, 68)


def test_dvbs2_min_degree_below_three_is_clamped():
    # min_degree < 3 is unsatisfiable under the diversity rule; the
    # optimizer must clamp instead of spinning in the sanitizer
    from myldpccppapi.codes.design import optimize_dvbs2_profile

    bi, thr = optimize_dvbs2_profile(16200, "1/2", steps=1, min_degree=2)
    assert bi.sum(axis=0).min() >= 3
