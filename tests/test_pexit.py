"""PEXIT threshold analysis: J-function fidelity, literature anchor values,
rate monotonicity, puncturing, and multi-edge protographs."""
import numpy as np
import pytest

from myldpccppapi.codes.pexit import (
    J, J_inv, pexit_run, protograph, threshold_ebn0, threshold_sigma,
)


def test_j_roundtrip_and_monotonicity():
    x = np.linspace(1e-4, 0.9995, 400)
    assert np.max(np.abs(J(J_inv(x)) - x)) < 5e-3
    s = np.linspace(0.0, 12.0, 500)
    j = J(s)
    assert (np.diff(j) >= -1e-12).all()
    assert J(0.0) == 0.0 and J(11.0) == 1.0


def test_regular_36_threshold_matches_literature():
    # (3,6)-regular LDPC: published BP threshold sigma* = 0.8809
    # (Richardson & Urbanke); the Gaussian approximation lands within 1%.
    b = np.ones((3, 6), dtype=int)
    sigma = threshold_sigma(b)
    assert abs(sigma - 0.881) < 0.01
    thr = threshold_ebn0(b)
    assert abs(thr - 1.11) < 0.1


def test_multiedge_protograph_equals_expanded():
    # [[3,3]] with multiplicity 3 IS the (3,6) ensemble
    assert abs(
        threshold_ebn0(np.array([[3, 3]])) - threshold_ebn0(np.ones((3, 6), int))
    ) < 0.02


def test_wimax_thresholds_monotone_in_rate_and_above_capacity():
    from myldpccppapi.codes.wimax import wimax

    # BPSK capacity limits (Eb/N0, dB) per rate
    capacity = {"1/2": 0.187, "3/4B": 1.626, "5/6": 2.362}
    thr = {r: threshold_ebn0(wimax(576, r)) for r in capacity}
    assert thr["1/2"] < thr["3/4B"] < thr["5/6"]
    for r, cap in capacity.items():
        assert thr[r] > cap - 0.05          # never beats capacity
        assert thr[r] < cap + 1.5           # and is in the right ballpark


def test_wimax_half_rate_beats_regular():
    # the 802.16e irregular profile must beat the (3,6) regular ensemble
    from myldpccppapi.codes.wimax import wimax

    assert threshold_ebn0(wimax(576, "1/2")) < 1.0


def test_nr_puncturing_is_handled():
    from myldpccppapi.codes.nr import nr_code

    code = nr_code(z=32, bg=1)
    assert code.punctured_front == 2 * 32
    thr = threshold_ebn0(code)
    # rate-1/3 BPSK capacity is -0.50 dB; BG1-class protographs sit within
    # ~0.5 dB of it BECAUSE of the punctured high-degree front
    assert -0.50 < thr < 0.5
    # dropping the puncturing info (treating punctured VNs as transmitted
    # at the same Eb) must change the answer
    b = protograph(code)
    thr_nopunct = threshold_ebn0(
        b, rate=code.k_info / (code.n - code.punctured_front)
    )
    assert thr_nopunct != pytest.approx(thr, abs=1e-3)


def test_dvbs2_multiedge_and_mask_paths():
    from myldpccppapi.codes.dvbs2 import dvbs2

    code = dvbs2(16200, "1/2")
    b = protograph(code)
    # extra_blocks must be counted with multiplicity
    assert b.max() >= 2 or code.extra_blocks is None
    thr = threshold_ebn0(code)
    assert 0.0 < thr < 2.5


def test_pexit_run_reports_ber_and_stalls():
    b = np.ones((3, 6), dtype=int)
    # well above threshold: converges, low BER
    ok = pexit_run(b, np.full(6, 8.0 * 0.5 * 10 ** (3.0 / 10)))
    assert ok.converged and (ok.ber <= 1e-5).all()
    # well below: hits the fixed-point stall break, not max_iters
    bad = pexit_run(b, np.full(6, 8.0 * 0.5 * 10 ** (-1.0 / 10)),
                    max_iters=2000)
    assert not bad.converged
    assert bad.iterations < 2000
    assert bad.ber.max() > 1e-3


def test_threshold_inf_when_unachievable():
    # a rate-0.9 protograph asked to converge below capacity
    b = np.ones((1, 10), dtype=int)
    assert threshold_ebn0(b, hi=-1.0) == float("inf")
