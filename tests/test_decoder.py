"""Decoder tests: golden-model parity, convergence, early-exit semantics.

The flooding min-sum path must be *bit-exact* against the NumPy golden model
(the analogue of the reference's DecodeCPU ground truth, ``MyLdpc.cpp:684-784``)
at SNRs where decoding converges; layered and sum-product variants are checked
for correctness of the decoded codewords and convergence behaviour.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest

from myldpccppapi import Decoder, DecoderConfig, Encoder, wimax, wifi
from myldpccppapi.codes import encode_numpy
from myldpccppapi.ops import golden
from myldpccppapi.ops.channel import transmit


def _make_case(code, batch, snr_db, seed=0):
    enc = Encoder(code)
    rng = np.random.default_rng(seed)
    u = rng.integers(0, 2, size=(batch, code.k), dtype=np.uint8)
    c = encode_numpy(enc.mats, u)
    llr, _ = transmit(jax.random.PRNGKey(seed), jnp.asarray(c), snr_db=snr_db)
    return u, c, np.asarray(llr, dtype=np.float32)


def test_flooding_minsum_matches_golden_bitexact():
    code = wimax(576, "3/4B")
    u, c, llr = _make_case(code, batch=24, snr_db=6.0)
    gb, gc, gi = golden.decode_golden(code, llr)
    dec = Decoder(code, DecoderConfig(schedule="flooding"))
    res = dec(jnp.asarray(llr))
    assert gc.all()
    assert (np.asarray(res.bits) == gb).all()
    assert (np.asarray(res.iterations) == gi).all()
    assert (np.asarray(res.bits)[:, : code.k] == u).all()


@pytest.mark.parametrize("schedule", ["flooding", "layered"])
@pytest.mark.parametrize("algorithm", ["min-sum", "sum-product"])
def test_decode_recovers_codewords(schedule, algorithm):
    code = wimax(576, "1/2")
    u, c, llr = _make_case(code, batch=16, snr_db=4.0, seed=3)
    dec = Decoder(code, DecoderConfig(algorithm=algorithm, schedule=schedule))
    res = dec(jnp.asarray(llr))
    assert np.asarray(res.converged).all()
    assert (np.asarray(res.bits)[:, : code.k] == u).all()
    # converged outputs must be valid codewords (the built-in oracle)
    assert code.syndrome(np.asarray(res.bits)).sum() == 0


def test_layered_converges_faster_than_flooding():
    code = wifi(1944, "5/6")
    _, _, llr = _make_case(code, batch=16, snr_db=6.5, seed=7)
    res_f = Decoder(code, DecoderConfig(schedule="flooding"))(jnp.asarray(llr))
    res_l = Decoder(code, DecoderConfig(schedule="layered"))(jnp.asarray(llr))
    assert np.asarray(res_l.converged).all()
    assert np.asarray(res_l.iterations).mean() < np.asarray(res_f.iterations).mean()


def test_early_exit_stops_iterating():
    code = wimax(576, "3/4B")
    _, c, llr = _make_case(code, batch=8, snr_db=10.0)
    res = Decoder(code, DecoderConfig(max_iters=40))(jnp.asarray(llr))
    assert int(res.total_iters) < 5  # clean channel converges almost instantly
    res_no = Decoder(code, DecoderConfig(max_iters=40, early_exit=False))(jnp.asarray(llr))
    assert int(res_no.total_iters) == 40
    # early exit must not change the decoded output
    assert (np.asarray(res.bits) == np.asarray(res_no.bits)).all()


def test_per_codeword_latching():
    """A converged codeword's output must freeze while the batch continues
    (reference isDones semantics, decodeCL.c:27-28,296-300)."""
    code = wimax(576, "1/2")
    u, c, llr = _make_case(code, batch=4, snr_db=5.0, seed=11)
    # corrupt one codeword so hard it cannot converge: zero out its LLRs
    llr_bad = llr.copy()
    llr_bad[2] = 0.0
    res = Decoder(code, DecoderConfig(max_iters=10))(jnp.asarray(llr_bad))
    conv = np.asarray(res.converged)
    assert conv[[0, 1, 3]].all()
    bits = np.asarray(res.bits)
    assert (bits[[0, 1, 3]][:, : code.k] == u[[0, 1, 3]]).all()
    its = np.asarray(res.iterations)
    assert (its[[0, 1, 3]] < 10).all() and its[2] == 10


def test_normalized_minsum_beats_plain_at_low_snr():
    """Normalized min-sum (alpha=0.75) should decode at least as many frames
    as plain min-sum near threshold — the classic improvement the reference
    lacks (SURVEY.md §2.2 notes its min-sum has no normalization)."""
    code = wimax(576, "1/2")
    u, c, llr = _make_case(code, batch=64, snr_db=2.0, seed=5)
    plain = Decoder(code, DecoderConfig(schedule="layered"))(jnp.asarray(llr))
    norm = Decoder(code, DecoderConfig(schedule="layered", normalization=0.75))(jnp.asarray(llr))
    n_ok_plain = int(np.asarray(plain.converged).sum())
    n_ok_norm = int(np.asarray(norm.converged).sum())
    assert n_ok_norm >= n_ok_plain


def test_offset_minsum_runs():
    code = wimax(576, "1/2")
    u, _, llr = _make_case(code, batch=8, snr_db=4.0)
    res = Decoder(code, DecoderConfig(offset=0.15))(jnp.asarray(llr))
    assert np.asarray(res.converged).all()
    assert (np.asarray(res.bits)[:, : code.k] == u).all()


@pytest.mark.slow
def test_all_wimax_rates_decode():
    for rate in ["1/2", "2/3A", "2/3B", "3/4A", "3/4B", "5/6"]:
        code = wimax(576, rate)
        u, _, llr = _make_case(code, batch=4, snr_db=7.0, seed=2)
        res = Decoder(code, DecoderConfig(schedule="layered"))(jnp.asarray(llr))
        assert np.asarray(res.converged).all(), rate
        assert (np.asarray(res.bits)[:, : code.k] == u).all(), rate


class TestSoftOutput:
    """DecoderConfig.soft_output: posterior LLRs latched at convergence."""

    def _decode(self, schedule, **kw):
        import jax

        from myldpccppapi.codes.encoder import Encoder, encode_numpy
        from myldpccppapi.codes.wimax import wimax
        from myldpccppapi.decoder import Decoder
        from myldpccppapi.utils.config import DecoderConfig

        code = wimax(576, "1/2")
        rng = np.random.default_rng(5)
        enc = Encoder(code)
        u = rng.integers(0, 2, size=(32, code.k_info), dtype=np.uint8)
        c = encode_numpy(enc.mats, u)
        sigma = 10 ** (-2.8 / 20)
        y = (1.0 - 2.0 * c.astype(np.float32)) + rng.normal(
            0, sigma, c.shape
        ).astype(np.float32)
        llr = jnp.asarray(2.0 * y / sigma**2)
        cfg = DecoderConfig(schedule=schedule, normalization=0.75,
                            soft_output=True, **kw)
        dec = Decoder(code, cfg)
        return dec, dec(llr), llr

    @pytest.mark.parametrize("schedule", ["layered", "flooding"])
    def test_posterior_signs_match_bits(self, schedule):
        dec, res, _ = self._decode(schedule)
        assert dec.implementation == "jnp"  # auto routes soft output to jnp
        post = np.asarray(res.posteriors)
        assert post.shape == res.bits.shape
        np.testing.assert_array_equal(
            (post <= 0).astype(np.uint8), np.asarray(res.bits)
        )

    def test_posterior_latched_at_convergence(self):
        """A converged frame's posterior must not depend on how many extra
        iterations the rest of the batch burns (same latch as bits)."""
        _, res20, _ = self._decode("layered", max_iters=20)
        _, res40, _ = self._decode("layered", max_iters=40)
        m = np.asarray(res20.converged) & np.asarray(res40.converged)
        assert m.any()
        np.testing.assert_array_equal(
            np.asarray(res20.posteriors)[m], np.asarray(res40.posteriors)[m]
        )

    def test_soft_output_off_returns_none(self):
        from myldpccppapi.codes.wimax import wimax
        from myldpccppapi.decoder import Decoder
        from myldpccppapi.utils.config import DecoderConfig

        code = wimax(576, "1/2")
        dec = Decoder(code, DecoderConfig(implementation="jnp"))
        res = dec(jnp.ones((4, code.n), jnp.float32))
        assert res.posteriors is None

    def test_fused_impl_soft_contract(self, monkeypatch):
        import myldpccppapi.decoder as decoder_mod
        from myldpccppapi.codes.wimax import wimax
        from myldpccppapi.decoder import Decoder
        from myldpccppapi.utils.config import DecoderConfig

        code = wimax(576, "1/2")

        class _Gpu:
            platform = "gpu"

        monkeypatch.setattr(decoder_mod.jax, "devices", lambda *a: [_Gpu()])
        # soft output is a jnp-path feature: auto dispatch routes it there
        # on the card, and an explicit fused-kernel request refuses it
        dec = Decoder(code, DecoderConfig(soft_output=True))
        assert dec.implementation == "jnp"
        with pytest.raises(ValueError, match="soft_output"):
            Decoder(code, DecoderConfig(implementation="cuda",
                                        soft_output=True))
        with pytest.raises(ValueError, match="triage"):
            Decoder(code, DecoderConfig(implementation="jnp",
                                        soft_output=True, triage_iters=5))

    def test_edgelist_soft_output(self):
        from myldpccppapi.codes.wimax import wimax
        from myldpccppapi.decoder import Decoder
        from myldpccppapi.utils.config import DecoderConfig

        code = wimax(576, "1/2")
        cfg = DecoderConfig(schedule="layered", normalization=0.75,
                            implementation="edgelist", soft_output=True)
        dec = Decoder(code, cfg)
        rng = np.random.default_rng(2)
        llr = jnp.asarray(rng.normal(2.0, 1.0, (8, code.n)).astype(np.float32))
        res = dec(llr)
        post = np.asarray(res.posteriors)
        np.testing.assert_array_equal(
            (post <= 0).astype(np.uint8), np.asarray(res.bits)
        )


def test_explicit_pallas_rejected_on_unsupported_code(monkeypatch):
    """An EXPLICIT fused-kernel request (implementation="cuda") on a code
    the kernel cannot serve must raise (not silently run jnp mislabeled as
    fused) — on a GPU, and on any other platform."""
    import myldpccppapi.decoder as decoder_mod
    from myldpccppapi.codes.dvbs2 import dvbs2
    from myldpccppapi.decoder import Decoder
    from myldpccppapi.utils.config import DecoderConfig

    code = dvbs2(16200, "1/2")  # masked/multi-edge: kernel unsupported
    with pytest.raises(ValueError, match="needs a GPU"):
        Decoder(code, DecoderConfig(implementation="cuda"))

    class _Gpu:
        platform = "gpu"

    monkeypatch.setattr(decoder_mod.jax, "devices", lambda *a: [_Gpu()])
    with pytest.raises(ValueError, match="masked"):
        Decoder(code, DecoderConfig(implementation="cuda"))


def test_sum_product_rejects_minsum_knobs():
    from myldpccppapi.utils.config import DecoderConfig

    with pytest.raises(ValueError, match="min-sum knobs"):
        DecoderConfig(algorithm="sum-product", normalization=0.75)
    with pytest.raises(ValueError, match="min-sum knobs"):
        DecoderConfig(algorithm="sum-product", offset=0.1)


def test_weight_one_row_does_not_nan():
    """A base matrix with a degree-1 row (single-parity extension) must
    decode without NaN: the excluding-self min over one edge is clamped,
    not inf (inf - inf = NaN poisoned all messages before the clamp)."""
    from myldpccppapi.codes.qc import QCCode
    from myldpccppapi.ops.bp import decode_qc
    from myldpccppapi.utils.config import DecoderConfig

    base = np.array([
        [1, 3, 0, -1],
        [2, 0, -1, 0],
        [-1, -1, 5, -1],   # weight-1 row
    ], dtype=np.int32)
    code = QCCode(name="w1row", base=base, z=8)
    rng = np.random.default_rng(0)
    llr = jnp.asarray(rng.normal(3.0, 1.0, (4, code.n)).astype(np.float32))
    for schedule in ["layered", "flooding"]:
        cfg = DecoderConfig(schedule=schedule, max_iters=8,
                            implementation="jnp", soft_output=True)
        res = decode_qc(code, cfg, llr)
        assert np.isfinite(np.asarray(res.posteriors)).all()


def test_edgelist_honors_bf16():
    from myldpccppapi.codes.wimax import wimax
    from myldpccppapi.decoder import Decoder
    from myldpccppapi.utils.config import DecoderConfig

    code = wimax(576, "1/2")
    cfg = DecoderConfig(schedule="layered", normalization=0.75,
                        implementation="edgelist", msg_dtype="bfloat16",
                        soft_output=True)
    dec = Decoder(code, cfg)
    rng = np.random.default_rng(1)
    llr = jnp.asarray(rng.normal(4.0, 1.0, (8, code.n)).astype(np.float32))
    res = dec(llr)
    assert res.posteriors.dtype == jnp.bfloat16
    assert bool(jnp.all(res.converged))


class TestSelfCorrection:
    """SCMS (Savin 2008): sign-flip erasure on the flooding q carry."""

    def test_scms_beats_plain_minsum_at_fixed_budget(self):
        """Pinned seeds, 10-iteration budget, wimax 576 r1/2: SCMS must
        strictly beat uncorrected min-sum (measured ~2x FER at 2.5 dB —
        the literature's result, no tuned constant needed)."""
        import jax
        import jax.numpy as jnp
        import numpy as np

        from myldpccppapi import Decoder, DecoderConfig, Encoder, wimax
        from myldpccppapi.codes import encode_numpy
        from myldpccppapi.ops.channel import transmit

        code = wimax(576, "1/2")
        enc = Encoder(code)
        rng = np.random.default_rng(0)
        u = rng.integers(0, 2, size=(512, code.k), dtype=np.uint8)
        c = encode_numpy(enc.mats, u)
        llr, _ = transmit(jax.random.PRNGKey(25), jnp.asarray(c), snr_db=2.5)
        fers = {}
        for name, sc in (("ms", False), ("scms", True)):
            dec = Decoder(code, DecoderConfig(
                algorithm="min-sum", schedule="flooding", max_iters=10,
                self_correction=sc))
            res = dec(llr)
            bits = np.asarray(res.bits)
            fers[name] = int(
                (bits[:, code.info_positions] != u).any(axis=1).sum())
            # converged => valid codeword (erasures must not break the
            # syndrome latch)
            conv = np.asarray(res.converged)
            h = code.h_dense()
            syn = (bits[conv] @ h.T) & 1
            assert not syn.any()
        assert fers["scms"] < fers["ms"], fers

    def test_scms_validation_and_dispatch(self, monkeypatch):
        import pytest

        import myldpccppapi.decoder as decoder_mod

        from myldpccppapi import Decoder, DecoderConfig, wimax
        from myldpccppapi.coder import Coder

        with pytest.raises(ValueError, match="FLOODING"):
            DecoderConfig(schedule="layered", self_correction=True)
        with pytest.raises(ValueError, match="FLOODING"):
            DecoderConfig(algorithm="sum-product", schedule="flooding",
                          self_correction=True)
        code = wimax(576, "1/2")
        # the edge-list path has no SCMS erasure memory
        with pytest.raises(ValueError, match="SCMS"):
            Decoder(code, DecoderConfig(
                schedule="flooding", self_correction=True,
                implementation="edgelist"))
        dec = Decoder(code, DecoderConfig(schedule="flooding",
                                          self_correction=True))
        assert dec.implementation == "jnp"  # auto on CPU

        class _Gpu:
            platform = "gpu"

        monkeypatch.setattr(decoder_mod.jax, "devices", lambda *a: [_Gpu()])
        # SCMS stays on jnp on the card; the fused kernel refuses it
        dec = Decoder(code, DecoderConfig(schedule="flooding",
                                          self_correction=True))
        assert dec.implementation == "jnp"
        with pytest.raises(ValueError, match="SCMS"):
            Decoder(code, DecoderConfig(
                schedule="flooding", self_correction=True,
                implementation="cuda"))
        monkeypatch.undo()
        # the Coder facade type
        coder = Coder(432, 576, "3/4B")
        coder.for_decoder(16)
        coder.add_decode_type("SCMS")
        assert coder._decoders["SCMS"].config.self_correction is True
