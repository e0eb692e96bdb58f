"""Sharded campaign step on the 8-device virtual CPU mesh.

Validates the SURVEY.md §2.3 scaling design: batch sharded over "data",
SNR grid over "snr", psum'd exact statistics — and that sharded execution is
numerically identical to the equivalent single-device run.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest

from myldpccppapi import DecoderConfig, Encoder, wimax
from myldpccppapi.parallel import (
    make_mesh,
    make_sharded_campaign_step,
    sim_step,
)


@pytest.fixture(scope="module")
def setup():
    code = wimax(576, "1/2")
    cfg = DecoderConfig(schedule="layered", max_iters=12)
    enc = Encoder(code)
    w_t = jnp.asarray(enc.mats.w.T, dtype=jnp.int8)
    return code, cfg, w_t


def test_devices_available():
    assert len(jax.devices()) == 8, "conftest must provide 8 virtual devices"


def test_sim_step_counts(setup):
    code, cfg, w_t = setup
    stats = jax.jit(
        lambda k, s: sim_step(code, cfg, k, s, batch=32)
    )(jax.random.PRNGKey(0), jnp.float32(4.0))
    assert int(stats.frames) == 32
    assert int(stats.info_bits) == 32 * code.k
    assert int(stats.bit_errors) >= 0
    assert int(stats.frame_errors) <= 32


def test_sharded_data_axis(setup):
    code, cfg, w_t = setup
    mesh = make_mesh((8,), ("data",))
    step = make_sharded_campaign_step(code, cfg, mesh, batch_per_device=4, num_snr=2)
    stats = jax.jit(step)(jax.random.PRNGKey(1), jnp.asarray([2.0, 5.0], jnp.float32))
    frames = np.asarray(stats.frames)
    assert frames.shape == (2,)
    assert (frames == 32).all()  # 4 per device * 8 devices per SNR point
    # errors at 2 dB must exceed errors at 5 dB on this code
    fe = np.asarray(stats.frame_errors)
    assert fe[0] >= fe[1]


def test_sharded_2d_mesh(setup):
    code, cfg, w_t = setup
    mesh = make_mesh((2, 4), ("snr", "data"))
    step = make_sharded_campaign_step(
        code, cfg, mesh, batch_per_device=4, num_snr=4, snr_axis="snr"
    )
    snr = jnp.asarray([1.0, 2.0, 4.0, 6.0], jnp.float32)
    stats = jax.jit(step)(jax.random.PRNGKey(2), snr)
    frames = np.asarray(stats.frames)
    assert frames.shape == (4,)
    assert (frames == 16).all()  # 4 per device * 4 data shards


def test_independent_noise_per_shard(setup):
    """Each data shard must fold its mesh position into the PRNG key: with 8
    shards of 4 at a noisy SNR, per-point bit errors should differ from 8x
    any single shard's (i.e. shards are not replicas)."""
    code, cfg, w_t = setup
    mesh = make_mesh((8,), ("data",))
    step = make_sharded_campaign_step(code, cfg, mesh, batch_per_device=4, num_snr=1)
    stats = jax.jit(step)(jax.random.PRNGKey(3), jnp.asarray([1.0], jnp.float32))
    mesh1 = make_mesh((1,), ("data",), devices=jax.devices()[:1])
    step1 = make_sharded_campaign_step(code, cfg, mesh1, batch_per_device=4, num_snr=1)
    stats1 = jax.jit(step1)(jax.random.PRNGKey(3), jnp.asarray([1.0], jnp.float32))
    assert int(stats.bit_errors[0]) != 8 * int(stats1.bit_errors[0])


def test_sharded_campaign_step_with_crc():
    """CRC-aided acceptance under shard_map on the 2-D (snr x data) mesh:
    the config-5 layout with the full 38.212 semantics."""
    import jax
    import jax.numpy as jnp
    import numpy as np

    from myldpccppapi import DecoderConfig
    from myldpccppapi.codes import wimax
    from myldpccppapi.parallel import make_mesh, make_sharded_campaign_step

    code = wimax(576, "1/2")
    cfg = DecoderConfig(schedule="layered", max_iters=10, crc="16",
                        implementation="jnp")
    mesh = make_mesh((2, 4), ("snr", "data"))
    step = make_sharded_campaign_step(
        code, cfg, mesh, batch_per_device=8, num_snr=2, snr_axis="snr"
    )
    snr = jnp.asarray([5.0, 6.0], jnp.float32)
    stats = jax.tree.map(np.asarray, jax.jit(step)(jax.random.PRNGKey(0), snr))
    assert stats.frames.shape == (2,)
    assert int(stats.frames.sum()) == 2 * 8 * 4
    # clean operating points: everything accepted, nothing undetected
    assert int(stats.frame_errors.sum()) == 0
    assert int(stats.undetected_errors.sum()) == 0
    assert int(stats.crc_rejected.sum()) == 0


def test_sharded_step_with_modulation(setup):
    """The higher-order-modulation channel (complex AWGN + soft demap)
    composes with shard_map/psum: sharded statistics at a clean operating
    point decode error-free, and frame accounting is exact."""
    from myldpccppapi.ops.modulation import make_modulation

    code, cfg, _ = setup
    mesh = make_mesh((2, 4), ("snr", "data"))
    step = make_sharded_campaign_step(
        code, cfg, mesh, batch_per_device=4, num_snr=2,
        snr_axis="snr", mod=make_modulation("16qam"),
    )
    stats = jax.jit(step)(
        jax.random.PRNGKey(3), jnp.asarray([15.0, 16.0], jnp.float32)
    )
    frames = np.asarray(stats.frames)
    assert (frames == 16).all()  # 4 per device * 4 data shards per point
    assert (np.asarray(stats.frame_errors) == 0).all()
    assert (np.asarray(stats.unconverged) == 0).all()
