"""Higher-order modulation: constellations, soft demappers, end-to-end sim.

The reference's channel is BPSK-only (``MyLdpc.cpp:1061-1078``); these tests
cover the framework's QAM/PSK/APSK extension (ops/modulation.py): closed-form
TS 38.211 Gray QAM properties, EN 302 307 APSK geometry, demapper exactness
(QPSK max-log == the analytic per-component BPSK LLR), and decoder roundtrips
through the soft demapper.
"""
import numpy as np
import jax
import jax.numpy as jnp
import pytest

from myldpccppapi.ops import modulation as M
from myldpccppapi.ops.modulation import demap_llr, make_modulation, modulate

ALL_MODS = sorted(M.MODULATIONS)


@pytest.mark.parametrize("name", ALL_MODS)
def test_unit_energy_and_label_permutation(name):
    mod = make_modulation(name)
    pts = np.asarray(mod.points)
    assert abs(np.mean(np.abs(pts) ** 2) - 1.0) < 1e-5
    m = mod.bits_per_symbol
    ints = mod.labels.astype(np.int64) @ (1 << np.arange(m))
    assert sorted(ints.tolist()) == list(range(2**m))


@pytest.mark.parametrize("name", ["qpsk", "16qam", "64qam", "256qam"])
def test_nr_qam_gray_adjacency(name):
    """TS 38.211 QAM is Gray: every minimum-distance point pair differs in
    exactly one label bit."""
    mod = make_modulation(name)
    pts, labs = np.asarray(mod.points), mod.labels
    m = mod.bits_per_symbol
    ints = labs.astype(np.int64) @ (1 << np.arange(m))
    d = np.abs(pts[:, None] - pts[None, :])
    np.fill_diagonal(d, np.inf)
    dmin = d.min()
    ii, jj = np.where(np.abs(d - dmin) < 1e-6)
    hams = [bin(int(ints[i]) ^ int(ints[j])).count("1") for i, j in zip(ii, jj)]
    assert hams and all(h == 1 for h in hams)


def test_qam16_matches_published_alphabet():
    """§5.1.4's I/Q amplitude alphabet is {±1, ±3}/sqrt(10)."""
    mod = make_modulation("16qam")
    re = np.unique(np.round(np.real(mod.points) * np.sqrt(10)).astype(int))
    assert re.tolist() == [-3, -1, 1, 3]


def test_psk8_ring_gray():
    mod = make_modulation("8psk")
    ints = mod.labels.astype(np.int64) @ (1 << np.arange(3))
    # neighbors around the ring differ in exactly one bit (incl. wraparound)
    order = np.argsort(np.angle(np.asarray(mod.points)))
    ring = ints[order]
    for a, b in zip(ring, np.roll(ring, -1)):
        assert bin(int(a) ^ int(b)).count("1") == 1


@pytest.mark.parametrize("name,rate,nring", [("16apsk", "2/3", 2),
                                             ("32apsk", "4/5", 3)])
def test_apsk_geometry(name, rate, nring):
    """EN 302 307 geometry: 4/12(/16) points per ring, table ring ratios."""
    mod = make_modulation(name, rate=rate)
    radii = np.abs(np.asarray(mod.points))
    uniq = np.unique(np.round(radii, 5))
    assert len(uniq) == nring
    counts = [int(np.sum(np.abs(radii - r) < 1e-4)) for r in uniq]
    assert counts == [4, 12, 16][:nring]
    if name == "16apsk":
        assert abs(uniq[1] / uniq[0] - M.APSK16_GAMMA[rate]) < 1e-3
    else:
        g1, g2 = M.APSK32_GAMMA[rate]
        assert abs(uniq[1] / uniq[0] - g1) < 1e-3
        assert abs(uniq[2] / uniq[0] - g2) < 1e-3


@pytest.mark.parametrize("name", ALL_MODS)
@pytest.mark.parametrize("method", ["maxlog", "exact"])
def test_demap_roundtrip_low_noise(name, method, rng):
    mod = make_modulation(name)
    m = mod.bits_per_symbol
    bits = rng.integers(0, 2, (3, 40 * m)).astype(np.int8)
    y = modulate(jnp.asarray(bits), mod)
    llr = demap_llr(y, 1e-3, mod, method)
    assert llr.shape == bits.shape
    hard = np.asarray(llr) < 0
    np.testing.assert_array_equal(hard.astype(np.int8), bits)


def test_qpsk_maxlog_equals_analytic_bpsk_llr(rng):
    """QPSK decomposes into two BPSKs of amplitude 1/sqrt(2): the max-log
    LLR must equal 2 * (component) * sqrt(2) * 2 / n0 exactly."""
    mod = make_modulation("qpsk")
    y = (rng.standard_normal(200) + 1j * rng.standard_normal(200)).astype(
        np.complex64
    )
    n0 = 0.37
    llr = np.asarray(demap_llr(jnp.asarray(y), n0, mod))
    a = 1 / np.sqrt(2)
    np.testing.assert_allclose(llr[0::2], 4 * a * np.real(y) / n0, rtol=2e-4)
    np.testing.assert_allclose(llr[1::2], 4 * a * np.imag(y) / n0, rtol=2e-4)


def test_exact_close_to_maxlog_at_high_snr(rng):
    mod = make_modulation("16qam")
    bits = rng.integers(0, 2, (256,)).astype(np.int8)
    y = modulate(jnp.asarray(bits), mod)
    y = y + 0.02 * (rng.standard_normal(y.shape)
                    + 1j * rng.standard_normal(y.shape)).astype(np.complex64)
    n0 = 2 * 0.02**2
    l1 = np.asarray(demap_llr(y, n0, mod, "maxlog"))
    l2 = np.asarray(demap_llr(y, n0, mod, "exact"))
    assert np.all(np.sign(l1) == np.sign(l2))
    np.testing.assert_allclose(l1, l2, rtol=0.02, atol=0.5)


def test_modulate_rejects_ragged_bits():
    mod = make_modulation("8psk")
    with pytest.raises(ValueError, match="divisible"):
        modulate(jnp.zeros((4, 16), jnp.int8), mod)


# ---------------------------------------------------------------------------
# End-to-end through the decoder
# ---------------------------------------------------------------------------


def _wimax_sim(mod_name, snr_db, batch, seed=0, demap="maxlog"):
    from myldpccppapi.codes.wimax import wimax
    from myldpccppapi.parallel.sim import sim_step
    from myldpccppapi.utils.config import DecoderConfig

    code = wimax(576, "1/2")
    cfg = DecoderConfig(algorithm="min-sum", schedule="layered",
                        max_iters=30, normalization=0.75,
                        implementation="jnp")
    mod = None if mod_name == "bpsk" else make_modulation(mod_name)
    step = jax.jit(
        lambda k, s: sim_step(code, cfg, k, s, batch, mod=mod, demap=demap)
    )
    return step(jax.random.PRNGKey(seed), jnp.float32(snr_db))


@pytest.mark.parametrize("name,snr_db", [
    ("qpsk", 7.0), ("16qam", 14.0), ("16apsk", 15.0), ("8psk", 12.0),
])
def test_sim_step_clean_decode_through_demapper(name, snr_db):
    stats = _wimax_sim(name, snr_db, batch=64)
    assert int(stats.frames) == 64
    assert int(stats.frame_errors) == 0
    assert int(stats.unconverged) == 0


def test_qpsk_waterfall_matches_bpsk_at_plus_3dB():
    """QPSK at Es/sigma^2 = s+3.01 dB is bit-for-bit the same channel as
    BPSK at s dB (two independent half-energy components), so FERs must
    agree statistically."""
    batch, snr = 512, 2.6
    f_b = sum(
        int(_wimax_sim("bpsk", snr, batch, seed=s).frame_errors)
        for s in range(4)
    )
    f_q = sum(
        int(_wimax_sim("qpsk", snr + 10 * np.log10(2), batch, seed=s).frame_errors)
        for s in range(4)
    )
    n = 4 * batch
    p = (f_b + f_q) / (2 * n)
    sd = max(np.sqrt(2 * n * p * (1 - p)), 1.0)
    assert abs(f_b - f_q) < 5 * sd, (f_b, f_q)


def test_sim_step_rejects_llr_scale_with_mod():
    from myldpccppapi.codes.wimax import wimax
    from myldpccppapi.parallel.sim import sim_step
    from myldpccppapi.utils.config import DecoderConfig

    code = wimax(576, "1/2")
    cfg = DecoderConfig(implementation="jnp")
    with pytest.raises(ValueError, match="llr_scale"):
        sim_step(code, cfg, jax.random.PRNGKey(0), 5.0, 8,
                 llr_scale=1.0, mod=make_modulation("qpsk"))


@pytest.mark.parametrize("name", ["qpsk", "16qam", "64qam", "256qam"])
@pytest.mark.parametrize("method", ["maxlog", "exact"])
def test_separable_demap_equals_full(name, method, rng):
    """Square Gray QAM demaps per-axis against the PAM alphabet (L levels
    instead of L^2 points); the other axis's terms cancel, so this must
    equal the generic full-constellation computation to float tolerance."""
    import dataclasses

    mod = make_modulation(name)
    assert mod.pam is not None
    full = dataclasses.replace(mod, pam=None)
    y = jnp.asarray(
        (rng.standard_normal(400) + 1j * rng.standard_normal(400)).astype(
            np.complex64
        )
    )
    a = np.asarray(demap_llr(y, 0.4, mod, method))
    b = np.asarray(demap_llr(y, 0.4, full, method))
    np.testing.assert_allclose(a, b, rtol=2e-3, atol=1e-3)


def test_psk_apsk_have_no_pam():
    for name in ["bpsk", "8psk", "16apsk", "32apsk"]:
        assert make_modulation(name).pam is None
