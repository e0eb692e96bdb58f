"""A priori-aware demapping + the BICM-ID loop.

The prior-aware demapper is pinned against a brute-force APP reference
(full [.., M] metric tensor, the textbook formula) for generic and
separable constellations, both methods; the loop's mechanics are pinned
on a real code (n_outer=0 == one-shot, and the loop recovers clean
frames).  The measured FER gain story lives on chip
(benchmarks/bicm_id_bench.py) — Gray labelings are expected flat.
"""
import numpy as np
import pytest
import jax
import jax.numpy as jnp

from myldpccppapi.ops.modulation import (
    Modulation, apsk16, demap_llr, make_modulation, modulate, psk8, qam16,
    qam64,
)


def brute_app(y, n0, mod, prior, method):
    """Textbook APP demap via the full [.., S, M] metric tensor."""
    pts = jnp.asarray(mod.points)
    labels = np.asarray(mod.labels)  # [M, m]
    m = mod.bits_per_symbol
    d = jnp.square(jnp.abs(y[..., None] - pts)) / n0  # [..., S, M]
    if prior is not None:
        pri = prior.reshape(prior.shape[:-1] + (-1, m))  # [..., S, m]
        d = d + jnp.einsum("...sm,pm->...sp", pri, labels.astype(np.float32))
    out = []
    for i in range(m):
        one = labels[:, i].astype(bool)
        if method == "maxlog":
            l0 = jnp.min(jnp.where(~one, d, np.inf), axis=-1)
            l1 = jnp.min(jnp.where(one, d, np.inf), axis=-1)
            out.append(l1 - l0)
        else:
            from jax.scipy.special import logsumexp

            l0 = logsumexp(jnp.where(~one, -d, -np.inf), axis=-1)
            l1 = logsumexp(jnp.where(one, -d, -np.inf), axis=-1)
            out.append(l0 - l1)
    return jnp.stack(out, axis=-1).reshape(y.shape[:-1] + (-1,))


MODS = [psk8(), apsk16(), qam16(), qam64()]


@pytest.mark.parametrize("mod", MODS, ids=lambda m: m.name)
@pytest.mark.parametrize("method", ["maxlog", "exact"])
def test_demap_prior_matches_bruteforce(mod, method):
    rng = np.random.default_rng(3)
    batch, syms = 4, 24
    m = mod.bits_per_symbol
    bits = rng.integers(0, 2, (batch, syms * m)).astype(np.uint8)
    y = modulate(jnp.asarray(bits), mod)
    y = y + 0.2 * (rng.normal(size=y.shape) + 1j * rng.normal(size=y.shape))
    y = jnp.asarray(y.astype(np.complex64))
    n0 = 0.08
    prior = jnp.asarray(
        rng.normal(scale=2.0, size=(batch, syms * m)).astype(np.float32))
    got = demap_llr(y, n0, mod, method, prior=prior)
    want = brute_app(y, n0, mod, prior, method)
    np.testing.assert_allclose(np.asarray(got), np.asarray(want),
                               rtol=2e-4, atol=2e-4)
    # prior=None path unchanged vs brute force too
    got0 = demap_llr(y, n0, mod, method)
    want0 = brute_app(y, n0, mod, None, method)
    np.testing.assert_allclose(np.asarray(got0), np.asarray(want0),
                               rtol=2e-4, atol=2e-4)


def test_prior_only_app_equals_prior_for_product_labelings():
    """With an uninformative channel (huge n0) and a labeling where every
    bit pattern occurs exactly once (8PSK: all 2^3), the exact APP
    factorizes and must return the prior itself."""
    mod = psk8()
    rng = np.random.default_rng(0)
    y = jnp.zeros((2, 8), jnp.complex64)
    prior = jnp.asarray(rng.normal(size=(2, 24)).astype(np.float32))
    app = demap_llr(y, 1e9, mod, "exact", prior=prior)
    np.testing.assert_allclose(np.asarray(app), np.asarray(prior),
                               rtol=1e-3, atol=1e-3)


def test_bicm_id_zero_outer_equals_oneshot():
    from myldpccppapi import Decoder, DecoderConfig
    from myldpccppapi.codes import wimax
    from myldpccppapi.ops.bicm_id import make_bicm_id_receive

    code = wimax(576, "1/2")
    cfg = DecoderConfig(schedule="layered", normalization=0.75, max_iters=15)
    mod = psk8()
    rng = np.random.default_rng(1)
    bits = rng.integers(0, 2, (8, code.n)).astype(np.uint8)
    y = modulate(jnp.asarray(bits), mod)
    y = jnp.asarray(
        (np.asarray(y) + 0.25 * (rng.normal(size=y.shape)
                                 + 1j * rng.normal(size=y.shape))
         ).astype(np.complex64))
    n0 = 0.125
    rx0 = make_bicm_id_receive(code, cfg, mod, n_outer=0)
    res0 = rx0(y, n0)
    ref = Decoder(code, cfg)(demap_llr(y, n0, mod))
    assert (np.asarray(res0.bits) == np.asarray(ref.bits)).all()
    assert (np.asarray(res0.converged) == np.asarray(ref.converged)).all()


def test_bicm_id_loop_recovers_clean_frames_nongray():
    """Two outer exchanges on a NON-Gray (natural-binary) 8PSK at a clean
    operating point: every frame must decode to the transmitted codeword,
    and the loop must be jittable end-to-end."""
    from myldpccppapi import DecoderConfig, Encoder
    from myldpccppapi.codes import wimax
    from myldpccppapi.ops.bicm_id import make_bicm_id_receive
    from myldpccppapi.ops.modulation import _bits_of

    code = wimax(576, "1/2")
    enc = Encoder(code)
    natural = Modulation(
        "8psk_nat",
        np.exp(1j * (2 * np.pi * np.arange(8) / 8 + np.pi / 8)
               ).astype(np.complex64),
        _bits_of(np.arange(8), 3),
    )
    cfg = DecoderConfig(schedule="layered", normalization=0.75, max_iters=20)
    rx = jax.jit(make_bicm_id_receive(code, cfg, natural, n_outer=2))
    rng = np.random.default_rng(2)
    u = rng.integers(0, 2, (8, enc.k), dtype=np.uint8)
    cw = np.asarray(enc(jnp.asarray(u)))
    y = modulate(jnp.asarray(cw), natural)
    sigma_c = 0.18  # per-component; clean point for r1/2 @8PSK
    y = jnp.asarray(
        (np.asarray(y) + sigma_c * (rng.normal(size=y.shape)
                                    + 1j * rng.normal(size=y.shape))
         ).astype(np.complex64))
    res = rx(y, 2 * sigma_c ** 2)
    assert np.asarray(res.converged).all()
    assert (np.asarray(res.bits) == cw).all()


def test_bicm_id_interleaver_roundtrip():
    """Extrinsic feedback must traverse the interleaver both directions:
    with a random permutation pair, n_outer=0 must equal the one-shot
    deinterleaved decode bit-for-bit."""
    from myldpccppapi import Decoder, DecoderConfig
    from myldpccppapi.codes import wimax
    from myldpccppapi.ops.bicm_id import make_bicm_id_receive

    code = wimax(576, "1/2")
    cfg = DecoderConfig(schedule="layered", normalization=0.75, max_iters=12)
    mod = psk8()
    rng = np.random.default_rng(5)
    perm = jnp.asarray(rng.permutation(code.n))
    inv = jnp.argsort(perm)
    il = lambda x: x[..., perm]
    de_il = lambda x: x[..., inv]
    bits = rng.integers(0, 2, (4, code.n)).astype(np.uint8)
    y = modulate(jnp.asarray(bits)[..., perm], mod)
    y = jnp.asarray(
        (np.asarray(y) + 0.3 * (rng.normal(size=y.shape)
                                + 1j * rng.normal(size=y.shape))
         ).astype(np.complex64))
    n0 = 0.18
    rx = make_bicm_id_receive(code, cfg, mod, n_outer=1,
                              deinterleave=de_il, interleave=il)
    res = rx(y, n0)  # mechanics: runs, shapes right
    assert res.bits.shape == (4, code.n)
    rx0 = make_bicm_id_receive(code, cfg, mod, n_outer=0,
                               deinterleave=de_il, interleave=il)
    ref = Decoder(code, cfg)(de_il(demap_llr(y, n0, mod)))
    assert (np.asarray(rx0(y, n0).bits) == np.asarray(ref.bits)).all()


def test_bicm_id_sharded_campaign_step():
    """id_outer rides the sharded campaign path: the step must compile,
    run on the (snr x data) mesh, and count every frame."""
    import jax

    from myldpccppapi import DecoderConfig
    from myldpccppapi.codes import wimax
    from myldpccppapi.parallel import make_mesh, make_sharded_campaign_step

    code = wimax(576, "1/2")
    cfg = DecoderConfig(schedule="layered", normalization=0.75, max_iters=6)
    mesh = make_mesh((2, 4), ("snr", "data"))
    step = make_sharded_campaign_step(
        code, cfg, mesh, batch_per_device=4, num_snr=2, snr_axis="snr",
        mod=psk8(), id_outer=1,
    )
    stats = jax.jit(step)(jax.random.PRNGKey(0),
                          jnp.asarray([9.0, 12.0], jnp.float32))
    stats = jax.tree.map(np.asarray, stats)
    assert int(stats.frames.sum()) == 2 * 4 * 4
