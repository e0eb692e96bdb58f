"""Error-impulse probe: structured pairs find real low-weight structure,
healthy defaults stay clean, and the probe names the offending columns."""
import numpy as np
import pytest

from myldpccppapi.codes.dvbs2 import dvbs2
from myldpccppapi.codes.wimax import wimax
from myldpccppapi.ops.impulse import impulse_probe


def test_wimax_576_finds_low_weight_codeword():
    r = impulse_probe(wimax(576, "1/2"))
    assert r.min_weight is not None and r.min_weight <= 20
    # the found support IS a codeword
    code = wimax(576, "1/2")
    cw = np.zeros(code.n, dtype=np.int64)
    cw[r.support] = 1
    h = code.h_dense().astype(np.int64)
    assert not ((h @ cw) % 2).any()
    assert cw.sum() == r.min_weight


@pytest.mark.slow
def test_single_row_class_group_is_flagged():
    """A degree-3 group whose addresses sit in ONE residue class (the
    measured round-4 floor bug) must light up; the shipped designed table
    must stay clean on the same probe budget."""
    from myldpccppapi.codes.dvbs2 import dvbs2_ira_qc
    from myldpccppapi.codes.dvbs2_designed import DESIGNED_ADDRESSES

    good = DESIGNED_ADDRESSES[(16200, "1/2")]
    q = 25
    bad = list(good)
    bad[0] = (3, 3 + q * 50, 3 + q * 111)  # one residue class, 3 shifts
    code_bad = dvbs2_ira_qc(16200, "1/2", tuple(bad))
    # amplitude 12 sits between the two codes' correction radii: the
    # concentrated group's shared-check pairs trap the decoder, the
    # designed table's diverse pairs decode clean
    r_bad = impulse_probe(code_bad, columns=[0], max_pair_patterns=512,
                          amplitude=12.0)
    assert r_bad.breaches + len(r_bad.trapped) > 0
    if r_bad.min_weight is not None:
        assert 0 in r_bad.support_cols

    r_good = impulse_probe(dvbs2(16200, "1/2"), columns=[0],
                           max_pair_patterns=512, amplitude=12.0)
    assert r_good.breaches + len(r_good.trapped) == 0


def test_columns_filter_restricts_probes():
    code = wimax(576, "1/2")
    r_all = impulse_probe(code)
    r_one = impulse_probe(code, columns=[0])
    assert r_one.probes < r_all.probes
