"""Learned/weighted min-sum: weight schedules through every path, the
differentiable unrolled decoder, and the trainer."""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from myldpccppapi import Decoder, DecoderConfig, Encoder, wimax
from myldpccppapi.codes import encode_numpy
from myldpccppapi.ops.bp import canon_weights, decode_qc, weights_mode
from myldpccppapi.ops.channel import transmit
from myldpccppapi.ops.learned import (
    LearnedWeights,
    make_unrolled,
    soft_ber_loss,
    train_nms,
)


def _case(code, batch, snr_db, seed=0):
    enc = Encoder(code)
    rng = np.random.default_rng(seed)
    u = rng.integers(0, 2, size=(batch, code.k), dtype=np.uint8)
    c = encode_numpy(enc.mats, u)
    llr, _ = transmit(jax.random.PRNGKey(seed), jnp.asarray(c), snr_db=snr_db)
    return u, jnp.asarray(llr)


# ---------------------------------------------------------------------------
# Weight-schedule plumbing
# ---------------------------------------------------------------------------

def test_canon_weights_modes():
    assert canon_weights(0.75, 4) == ("scalar", 0.75)
    assert canon_weights((0.7, 0.8, 0.9, 1.0), 4)[0] == "layer"
    mode, rows = canon_weights(((0.7,), (0.8, 0.8, 0.8, 0.8)), 4)
    assert mode == "iter" and rows[0] == (0.7,) * 4
    with pytest.raises(ValueError):
        canon_weights((0.7, 0.8), 4)  # wrong per-layer length


def test_config_coerces_lists_and_hashes():
    cfg = DecoderConfig(normalization=[[0.7] * 12, [0.8] * 12])
    assert isinstance(cfg.normalization, tuple)
    assert isinstance(cfg.normalization[0], tuple)
    hash(cfg)  # jit-static usability
    assert weights_mode(cfg, 12) == "iter"


@pytest.mark.parametrize("schedule", ["layered", "flooding"])
def test_per_layer_uniform_matches_scalar(schedule):
    code = wimax(576, "1/2")
    _, llr = _case(code, batch=16, snr_db=3.0)
    ref = decode_qc(code, DecoderConfig(schedule=schedule,
                                        normalization=0.75), llr)
    per_layer = DecoderConfig(schedule=schedule,
                              normalization=(0.75,) * code.m_b)
    res = decode_qc(code, per_layer, llr)
    assert (np.asarray(res.bits) == np.asarray(ref.bits)).all()
    assert (np.asarray(res.iterations) == np.asarray(ref.iterations)).all()


def test_per_iteration_uniform_matches_scalar():
    code = wimax(576, "1/2")
    _, llr = _case(code, batch=16, snr_db=3.0, seed=2)
    ref = decode_qc(code, DecoderConfig(normalization=0.75), llr)
    # 3-row schedule, max_iters=40: iterations beyond the schedule reuse
    # the last row (all rows identical here)
    sched = ((0.75,) * code.m_b,) * 3
    res = decode_qc(code, DecoderConfig(normalization=sched), llr)
    assert (np.asarray(res.bits) == np.asarray(ref.bits)).all()
    assert (np.asarray(res.iterations) == np.asarray(ref.iterations)).all()


def test_distinct_per_layer_weights_decode():
    code = wimax(576, "1/2")
    u, llr = _case(code, batch=16, snr_db=5.0, seed=3)
    alphas = tuple(0.6 + 0.4 * i / code.m_b for i in range(code.m_b))
    res = decode_qc(code, DecoderConfig(normalization=alphas), llr)
    assert np.asarray(res.converged).all()
    assert (np.asarray(res.bits)[:, : code.k] == u).all()


def test_edgelist_rejects_weight_schedules():
    from myldpccppapi.ops.bp_edgelist import build_edge_index, decode_edgelist

    code = wimax(576, "1/2")
    rows, cols = code.h_coo()
    idx = build_edge_index(rows, cols, code.n, code.m)
    cfg = DecoderConfig(normalization=(0.75,) * code.m_b)
    with pytest.raises(NotImplementedError):
        decode_edgelist(idx, cfg, jnp.zeros((2, code.n)))


# ---------------------------------------------------------------------------
# Differentiable unrolled decoder
# ---------------------------------------------------------------------------

def test_unrolled_matches_decode_qc_when_nothing_converges():
    code = wimax(576, "1/2")
    _, llr = _case(code, batch=8, snr_db=-2.0, seed=5)
    T = 5
    cfg = DecoderConfig(schedule="layered", normalization=0.8,
                        max_iters=T, early_exit=False, soft_output=True)
    ref = decode_qc(code, cfg, llr)
    assert (np.asarray(ref.iterations) == T).all()  # nothing converges
    run = make_unrolled(code, T)
    params = {"alpha": jnp.full((T, code.m_b), 0.8),
              "beta": jnp.zeros((T, code.m_b))}
    posts = run(params, llr)
    np.testing.assert_allclose(
        np.asarray(posts[-1]), np.asarray(ref.posteriors), rtol=1e-5,
        atol=1e-4
    )
    bits = (np.asarray(posts[-1]) <= 0).astype(np.uint8)
    np.testing.assert_array_equal(bits, np.asarray(ref.bits))


def test_gradients_flow_through_unrolled():
    code = wimax(576, "1/2")
    u, llr = _case(code, batch=4, snr_db=2.0, seed=6)
    enc = Encoder(code)
    cw = encode_numpy(enc.mats, u).astype(np.float32)
    T = 3
    run = make_unrolled(code, T)

    def loss(a):
        params = {"alpha": a, "beta": jnp.zeros((T, code.m_b))}
        return soft_ber_loss(run(params, llr), jnp.asarray(cw))

    g = jax.grad(loss)(jnp.full((T, code.m_b), 0.75))
    assert np.isfinite(np.asarray(g)).all()
    assert float(jnp.abs(g).sum()) > 0.0


# ---------------------------------------------------------------------------
# Trainer
# ---------------------------------------------------------------------------

def test_train_nms_smoke_and_integration():
    code = wimax(576, "1/2")
    lw = train_nms(code, n_iters=4, steps=25, batch=64, snr_db=(1.5, 3.0),
                   lr=0.03, seed=1)
    assert lw.alpha.shape == (4, code.m_b)
    # held-out validation: the trained schedule must beat the init (0.75)
    # on a fixed batch (per-step losses are noisy across random batches)
    run = make_unrolled(code, 4)
    cw = jnp.zeros((256, code.n), jnp.float32)
    llr_v, _ = transmit(jax.random.PRNGKey(123), cw, snr_db=2.0)
    init = {"alpha": jnp.full((4, code.m_b), 0.75),
            "beta": jnp.zeros((4, code.m_b))}
    trained = {"alpha": jnp.asarray(lw.alpha), "beta": jnp.asarray(lw.beta)}
    l_init = float(soft_ber_loss(run(init, llr_v), cw))
    l_trained = float(soft_ber_loss(run(trained, llr_v), cw))
    assert l_trained < l_init
    # full schedule -> jnp path; per-layer collapse -> kernel-eligible
    cfg_iter = lw.decoder_config(max_iters=12)
    assert weights_mode(cfg_iter, code.m_b) == "iter"
    cfg_layer = lw.decoder_config(per_layer=True)
    assert weights_mode(cfg_layer, code.m_b) in ("layer", "scalar")
    u, llr = _case(code, batch=16, snr_db=5.0, seed=9)
    res = Decoder(code, cfg_iter)(llr)
    assert np.asarray(res.converged).all()
    assert (np.asarray(res.bits)[:, : code.k] == u).all()
    res2 = Decoder(code, cfg_layer)(llr)
    assert np.asarray(res2.converged).all()


def test_learned_weights_config_values():
    lw = LearnedWeights(
        alpha=np.array([[0.7, 0.8], [0.9, 1.0]], np.float32),
        beta=np.zeros((2, 2), np.float32),
        losses=(1.0,),
    )
    a, b = lw.config_values()
    assert b == 0.0 and a[1] == (pytest.approx(0.9), pytest.approx(1.0))
    a_l, b_l = lw.config_values(per_layer=True)
    assert a_l == (pytest.approx(0.8), pytest.approx(0.9)) and b_l == 0.0
