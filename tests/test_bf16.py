"""bfloat16 message mode: decodes correctly; jnp and edge-list paths agree."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest

from myldpccppapi import Decoder, DecoderConfig, Encoder, wimax
from myldpccppapi.codes import encode_numpy
from myldpccppapi.ops.channel import transmit


@pytest.fixture(scope="module")
def case():
    code = wimax(576, "3/4B")
    enc = Encoder(code)
    rng = np.random.default_rng(0)
    u = rng.integers(0, 2, size=(16, code.k), dtype=np.uint8)
    c = encode_numpy(enc.mats, u)
    llr, _ = transmit(jax.random.PRNGKey(0), jnp.asarray(c), snr_db=5.5)
    return code, u, llr


@pytest.mark.slow
@pytest.mark.parametrize("algorithm", ["min-sum", "sum-product"])
def test_bf16_decodes_and_paths_agree(case, algorithm):
    code, u, llr = case
    cfg = DecoderConfig(
        algorithm=algorithm,
        schedule="layered",
        msg_dtype="bfloat16",
        normalization=0.75 if algorithm == "min-sum" else 1.0,
    )
    r_jnp = Decoder(code, cfg, implementation="jnp")(llr)
    r_el = Decoder(code, cfg, implementation="edgelist")(llr)
    # bf16 is not bit-exact across differently-structured programs (XLA may
    # keep f32 intermediates inside fusions, so rounding points differ);
    # the contract is semantic: both paths converge everywhere at this
    # operating point and decode the true info bits.
    for r in (r_jnp, r_el):
        assert np.asarray(r.converged).all()
        assert (np.asarray(r.bits)[:, : code.k] == u).all()


def test_bf16_rejects_bad_dtype():
    with pytest.raises(ValueError):
        DecoderConfig(msg_dtype="float16")
