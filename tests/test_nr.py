"""5G-NR-style family: triangular encode, puncturing, rate matching, decode."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest

from myldpccppapi import Decoder, DecoderConfig
from myldpccppapi.codes.nr import (
    nr_code,
    rate_match_bits,
    rate_match_llr,
    triangular_encode_fn,
    triangular_encode_numpy,
)


@pytest.fixture(scope="module")
def code():
    return nr_code(z=32, bg=1)  # small lifting for CPU tests


def test_shapes(code):
    assert code.n == 68 * 32 and code.k == 22 * 32
    assert code.punctured_front == 2 * 32


def test_triangular_encode_valid_codeword(code, rng):
    u = rng.integers(0, 2, size=(4, code.k), dtype=np.uint8)
    c = triangular_encode_numpy(code, u)
    assert c.shape == (4, code.n)
    assert code.syndrome(c).sum() == 0


def test_jnp_encode_matches_numpy(code, rng):
    u = rng.integers(0, 2, size=(4, code.k), dtype=np.uint8)
    c_np = triangular_encode_numpy(code, u)
    c_j = np.asarray(triangular_encode_fn(code)(jnp.asarray(u)))
    assert (c_np == c_j).all()


def test_rate_match_roundtrip(code, rng):
    """bits -> rate-matched -> LLR de-rate-match must place soft values at
    the right codeword positions (0 where never sent)."""
    u = rng.integers(0, 2, size=(2, code.k), dtype=np.uint8)
    c = triangular_encode_numpy(code, u)
    e = code.n - code.punctured_front + 100  # wrap 100 bits (soft combining)
    tx = np.asarray(rate_match_bits(code, jnp.asarray(c), e))
    assert tx.shape == (2, e)
    llr_e = 1.0 - 2.0 * tx.astype(np.float32)  # perfect channel
    llr = np.asarray(rate_match_llr(code, jnp.asarray(llr_e), e))
    assert llr.shape == (2, code.n)
    # punctured front: no information
    assert (llr[:, : code.punctured_front] == 0).all()
    # transmitted-once positions carry +-1, wrapped positions +-2
    body = llr[:, code.punctured_front :]
    assert ((np.abs(body) == 1) | (np.abs(body) == 2)).all()
    signs_ok = (1.0 - 2.0 * c[:, code.punctured_front :]) * body >= 0
    assert signs_ok.all()


def test_rate_match_shortened(code, rng):
    """e smaller than the circular buffer: tail bits never sent get LLR 0."""
    u = rng.integers(0, 2, size=(2, code.k), dtype=np.uint8)
    c = triangular_encode_numpy(code, u)
    e = (code.n - code.punctured_front) - 200
    tx = np.asarray(rate_match_bits(code, jnp.asarray(c), e))
    llr_e = 1.0 - 2.0 * tx.astype(np.float32)
    llr = np.asarray(rate_match_llr(code, jnp.asarray(llr_e), e))
    assert (llr[:, : code.punctured_front] == 0).all()
    assert (llr[:, code.punctured_front + e :] == 0).all()  # untransmitted tail
    sent = llr[:, code.punctured_front : code.punctured_front + e]
    assert (np.abs(sent) == 1).all()


def test_bg2_structure_and_encode(rng):
    code2 = nr_code(z=16, bg=2)
    assert code2.n == 52 * 16 and code2.k == 10 * 16
    u = rng.integers(0, 2, size=(3, code2.k), dtype=np.uint8)
    c = triangular_encode_numpy(code2, u)
    assert code2.syndrome(c).sum() == 0


@pytest.mark.slow
def test_nr_end_to_end_decode(code, rng):
    """Full config-4 pipeline: encode -> rate match -> AWGN -> de-rate-match
    -> BP decode recovers the info bits (punctured bits included)."""
    u = rng.integers(0, 2, size=(8, code.k), dtype=np.uint8)
    c = triangular_encode_numpy(code, u)
    e = code.n - code.punctured_front
    tx = np.asarray(rate_match_bits(code, jnp.asarray(c), e)).astype(np.float32)
    snr_db = 6.0
    sigma = 10 ** (-snr_db / 20)
    noise = np.random.default_rng(0).normal(0, sigma, tx.shape).astype(np.float32)
    y = (1.0 - 2.0 * tx) + noise
    llr_e = 2.0 * y / sigma**2
    llr = rate_match_llr(code, jnp.asarray(llr_e), e)
    dec = Decoder(code, DecoderConfig(schedule="layered", normalization=0.8, max_iters=50))
    res = dec(llr)
    assert np.asarray(res.converged).all()
    assert (np.asarray(res.bits)[:, : code.k] == u).all()


def test_lifting_sets_and_parser():
    from myldpccppapi.codes.nr import (
        NR_LIFTING_SETS,
        lifting_set_index,
        nr_code,
        parse_bg_table,
    )

    all_z = sorted(z for zs in NR_LIFTING_SETS for z in zs)
    assert len(all_z) == 51 and all_z[0] == 2 and all_z[-1] == 384
    assert lifting_set_index(384) == 1 and lifting_set_index(208) == 6
    with pytest.raises(ValueError):
        lifting_set_index(17)
    # round-trip a mini table through the 38.212-format parser
    text = """
    # row col v0..v7
    0 0 1 2 3 4 5 6 7 8
    0 1 10 11 12 13 14 15 16 17
    1 1 0 0 0 0 0 0 0 0
    """
    tab = parse_bg_table(text)
    assert tab.shape == (2, 2, 8)
    assert tab[0, 0, 1] == 2 and tab[1, 0, 0] == -1
    # per-set selection: Z=24 (set 1) picks column 1, applied mod z
    import numpy as np

    full = np.full((46, 68, 8), -1, dtype=np.int32)
    from myldpccppapi.codes.nr import nr_base_graph

    raw = nr_base_graph(1)
    for s in range(8):
        full[:, :, s] = np.where(raw >= 0, (raw + s) % 384, -1)
    code = nr_code(z=24, bg=1, table=full)
    expect = np.where(raw >= 0, (raw + 1) % 384 % 24, -1)
    assert (code.base == expect).all()


def test_rv_rate_matching_roundtrip():
    """rv0-3 starting offsets per Table 5.4.2.1-2; LLR de-rate-matching
    recovers every transmitted position with soft combining."""
    import numpy as np

    from myldpccppapi.codes.nr import (
        nr_code,
        rate_match_bits,
        rate_match_llr,
        rv_start,
    )

    code = nr_code(z=16, bg=1)
    n_cb = code.n - code.punctured_front  # 66 * z
    z = code.z
    assert rv_start(code, 0) == 0
    assert rv_start(code, 1) == 17 * z
    assert rv_start(code, 2) == 33 * z
    assert rv_start(code, 3) == 56 * z
    # limited buffer rounds k0 down to a multiple of z
    assert rv_start(code, 1, n_cb=40 * z) % z == 0
    assert rv_start(code, 1, n_cb=40 * z) == (17 * 40 // 66) * z
    cw = jnp.asarray(np.arange(code.n) % 2, jnp.float32)[None]
    e = n_cb // 2
    for rv in range(4):
        tx = rate_match_bits(code, cw, e, rv=rv)
        k0 = rv_start(code, rv)
        assert tx.shape == (1, e)
        assert tx[0, 0] == cw[0, code.punctured_front + k0]
        # llr scatter puts values back at the right buffer positions
        llr = rate_match_llr(code, 2.0 * tx - 1.0, e, rv=rv)
        assert llr.shape == (1, code.n)
        assert (llr[0, : code.punctured_front] == 0).all()
        pos = code.punctured_front + (k0 + 7) % n_cb
        assert llr[0, pos] == 2.0 * cw[0, code.punctured_front + (k0 + 7) % n_cb] - 1.0


def test_rv_soft_combining():
    """Two transmissions (rv0 + rv2) accumulate LLRs in the buffer."""
    import numpy as np

    from myldpccppapi.codes.nr import nr_code, rate_match_llr

    code = nr_code(z=16, bg=2)
    n_cb = code.n - code.punctured_front
    e = n_cb  # full buffer each time
    ones = jnp.ones((1, e), jnp.float32)
    l0 = rate_match_llr(code, ones, e, rv=0)
    l2 = rate_match_llr(code, ones, e, rv=2)
    combined = l0 + l2
    assert (np.asarray(combined[0, code.punctured_front:]) == 2.0).all()


@pytest.mark.parametrize("bg", [1, 2])
@pytest.mark.parametrize("z", [16, 24, 20, 28, 36, 44, 52, 60])
def test_nr_lifting_grid(bg, z):
    """One lifting size from each of the eight TS 38.212 lifting sets, for
    both base graphs: construction, shift reduction mod z, and triangular
    encode validity (numpy/jax parity)."""
    import numpy as np

    from myldpccppapi.codes.nr import (
        lifting_set_index, nr_code, triangular_encode_fn,
        triangular_encode_numpy,
    )

    sets = {16: 0, 24: 1, 20: 2, 28: 3, 36: 4, 44: 5, 52: 6, 60: 7}
    assert lifting_set_index(z) == sets[z]
    code = nr_code(z=z, bg=bg)
    _, _, sh = code.blocks
    assert (np.asarray(sh) < z).all()
    rng_l = np.random.default_rng(z * 10 + bg)
    u = rng_l.integers(0, 2, size=(2, code.k), dtype=np.uint8)
    c = triangular_encode_numpy(code, u)
    assert not code.syndrome(c).any()
    assert (c[:, : code.k] == u).all()
    c_j = np.asarray(jax.jit(triangular_encode_fn(code))(jnp.asarray(u)))
    assert (c_j == c).all()


@pytest.mark.slow
def test_harq_rv_retransmission_e2e():
    """Full HARQ flow: an rv0 transmission of half the circular buffer
    fails at 2.5 dB; soft-combining the de-rate-matched LLRs of an rv2
    retransmission (independent noise) recovers every frame — the
    TS 38.212 incremental-redundancy contract end-to-end."""
    import numpy as np

    from myldpccppapi import Decoder, DecoderConfig
    from myldpccppapi.codes.nr import (
        nr_code, rate_match_bits, rate_match_llr, triangular_encode_fn,
    )

    code = nr_code(z=32, bg=1)
    e = (code.n - code.punctured_front) // 2  # rate 2/3 over the buffer
    rng = np.random.default_rng(9)
    u = jnp.asarray(rng.integers(0, 2, size=(16, code.k), dtype=np.uint8))
    cw = jax.jit(triangular_encode_fn(code))(u)
    dec = Decoder(code, DecoderConfig(schedule="layered", normalization=0.8,
                                      max_iters=30))
    sigma = 10 ** (-2.5 / 20)
    llrs = {}
    for rv in (0, 2):
        tx = rate_match_bits(code, cw, e, rv=rv)
        sym = 1.0 - 2.0 * tx.astype(jnp.float32)
        y = sym + sigma * jax.random.normal(
            jax.random.PRNGKey(100 + rv), sym.shape
        )
        llrs[rv] = rate_match_llr(code, 2.0 * y / sigma**2, e, rv=rv)
    r0 = dec(llrs[0])
    assert not np.asarray(r0.converged).any()  # first transmission fails
    rc = dec(llrs[0] + llrs[2])
    assert np.asarray(rc.converged).all()
    assert (np.asarray(rc.bits)[:, : code.k] == np.asarray(u)).all()


def test_synthetic_base_graph_girth6_at_design_lifting():
    """The synthetic tables must be 4-cycle-free at the design lifting
    (zmax=384): the published 38.212 tables are girth-optimized, and an
    unconstrained random table costs a measured error-floor penalty
    (BENCH_NOTES round-2 NR waterfall)."""
    import itertools

    from myldpccppapi.codes.nr import NR_ZMAX, nr_base_graph

    for bg in (1, 2):
        base = nr_base_graph(bg)
        for i1, i2 in itertools.combinations(range(base.shape[0]), 2):
            share = np.nonzero((base[i1] >= 0) & (base[i2] >= 0))[0]
            for j1, j2 in itertools.combinations(share.tolist(), 2):
                delta = (base[i1, j1] - base[i1, j2]
                         + base[i2, j2] - base[i2, j1]) % NR_ZMAX
                assert delta != 0, (bg, i1, i2, j1, j2)


def test_harq_combine_single_equals_rate_match(rng):
    from myldpccppapi.codes.nr import harq_combine, nr_code, rate_match_llr

    code = nr_code(z=16, bg=2)
    e = code.n - code.punctured_front
    llr_e = jnp.asarray(rng.standard_normal((3, e)).astype(np.float32))
    np.testing.assert_array_equal(
        np.asarray(harq_combine(code, [(llr_e, 0)])),
        np.asarray(rate_match_llr(code, llr_e, e, rv=0)),
    )
    with pytest.raises(ValueError, match="at least one"):
        harq_combine(code, [])


def test_harq_incremental_redundancy_recovers(rng):
    """IR HARQ (TS 38.212 §5.4.2.1): an rv0 transmission too weak to decode
    alone becomes decodable after soft-combining an rv2 retransmission; a
    same-rv chase retransmission also recovers (LLRs add)."""
    from myldpccppapi.codes.nr import (
        harq_combine, nr_code, rate_match_bits, triangular_encode_numpy,
    )

    code = nr_code(z=32, bg=1)
    batch = 8
    u = rng.integers(0, 2, size=(batch, code.k), dtype=np.uint8)
    c = jnp.asarray(triangular_encode_numpy(code, u))
    e = 28 * code.z  # high effective rate: only part of the buffer per tx
    snr_db = 2.5
    sigma = 10 ** (-snr_db / 20)
    dec = Decoder(
        code,
        DecoderConfig(schedule="layered", normalization=0.8, max_iters=40),
    )
    nrng = np.random.default_rng(7)

    def rx(rv):
        tx = np.asarray(rate_match_bits(code, c, e, rv=rv)).astype(np.float32)
        y = (1.0 - 2.0 * tx) + nrng.normal(0, sigma, tx.shape).astype(np.float32)
        return jnp.asarray(2.0 * y / sigma**2)

    rx0, rx2, rx0b = rx(0), rx(2), rx(0)
    res_alone = dec(harq_combine(code, [(rx0, 0)]))
    ok_alone = (
        np.asarray(res_alone.converged)
        & (np.asarray(res_alone.bits)[:, : code.k] == u).all(axis=1)
    )
    assert not ok_alone.all(), "operating point too easy: rv0 alone decodes"
    for tx2 in [(rx2, 2), (rx0b, 0)]:  # IR and chase
        res = dec(harq_combine(code, [(rx0, 0), tx2]))
        assert np.asarray(res.converged).all()
        assert (np.asarray(res.bits)[:, : code.k] == u).all()
