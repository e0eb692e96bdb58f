"""Learned (neural) normalized min-sum: differentiable unrolled decoding
and on-device weight training.

Classic normalized/offset min-sum uses one scalar correction; "neural"
min-sum (Nachmani et al. 2016's learning-to-decode line, specialized to
shared per-iteration/per-layer weights) trains a small schedule
``alpha[t, layer]``/``beta[t, layer]`` by gradient descent through the
unrolled decoder.  This is a capability the reference's OpenCL design
could never express — here the decoder is a pure function, so
``jax.grad`` through T unrolled sweeps + optax IS the trainer, and it
runs on the same device the production decoder uses.

Integration: :meth:`LearnedWeights.decoder_config` drops the trained
schedule into ``DecoderConfig.normalization/offset``.  Per-layer schedules
(``per_layer=True`` collapse) also run on the fused CUDA kernel (one
weight pair per layer, ops/cuda_bp.py ``kernel_weights``); full
per-iteration schedules run on the jnp path (``implementation="auto"``
routes there).

Training uses the all-zero codeword by default: BP with min-sum updates is
symmetric under the channel's sign flips, so the error probability is
codeword-independent on a symmetric AWGN channel — random-codeword
training (pass ``encode_fn``) is available for cross-checks.  Loss is the
mean soft-BER (sigmoid cross-entropy on the posterior margins) summed over
all T iteration outputs (the "multiloss" that trains early iterations to
make progress, not just the last one).
"""
from __future__ import annotations

import dataclasses
from typing import Optional, Tuple

import jax
import jax.numpy as jnp
import numpy as np

from ..codes.qc import QCCode
from .bp import (
    _Q_INF,
    _aligners,
    _check_update_minsum,
    _from_blocks,
    _layers,
    _mask_col,
    _to_blocks,
)

__all__ = ["LearnedWeights", "make_unrolled", "soft_ber_loss", "train_nms"]


def make_unrolled(code: QCCode, n_iters: int, schedule: str = "layered"):
    """Differentiable fixed-budget min-sum decoder.

    Returns ``run(params, llr) -> posteriors[T, B, n]`` where params is a
    dict with ``alpha``/``beta`` of shape [T, n_layers] (traced — the whole
    thing is differentiable in them; a first dim of 1 ties the weights
    across iterations, the kernel-servable per-layer form).  No early
    exit, no latching: every iteration's posterior is an output (multiloss
    training).  The sweep math is exactly ops/bp.py's (same helpers),
    minus the while_loop.
    """
    layers = _layers(code)
    n_b, z = code.n_b, code.z
    _row_align, _col_align = _aligners(code)

    def run(params, llr: jax.Array) -> jax.Array:
        a_rows = params["alpha"].shape[0]
        b_rows = params["beta"].shape[0]
        alpha = lambda t, li: params["alpha"][min(t, a_rows - 1), li]
        beta = lambda t, li: params["beta"][min(t, b_rows - 1), li]
        chan = _to_blocks(llr, n_b, z)
        post = chan
        r = [jnp.zeros_like(chan[0])] * code.num_blocks
        outs = []
        for t in range(n_iters):
            if schedule == "layered":
                for li, (_, entries) in enumerate(layers):
                    qs = []
                    for (e, j, s, mask) in entries:
                        q = _row_align(post[j], s) - r[e]
                        if mask is not None:
                            q = jnp.where(_mask_col(mask), q, _Q_INF)
                        qs.append(q)
                    rn = _check_update_minsum(
                        jnp.stack(qs), alpha(t, li), beta(t, li)
                    )
                    for idx, (e, j, s, mask) in enumerate(entries):
                        delta = rn[idx] - r[e]
                        if mask is not None:
                            delta = jnp.where(_mask_col(mask), delta, 0.0)
                        post = post.at[j].add(_col_align(delta, s))
                        r[e] = rn[idx]
            else:  # flooding
                rn_all = []
                for li, (_, entries) in enumerate(layers):
                    qs = []
                    for (e, j, s, mask) in entries:
                        q = _row_align(post[j], s) - r[e]
                        if mask is not None:
                            q = jnp.where(_mask_col(mask), q, _Q_INF)
                        qs.append(q)
                    rn_all.append(
                        _check_update_minsum(
                            jnp.stack(qs), alpha(t, li), beta(t, li)
                        )
                    )
                post = chan
                for (_, entries), rn in zip(layers, rn_all):
                    for idx, (e, j, s, mask) in enumerate(entries):
                        contrib = rn[idx]
                        if mask is not None:
                            contrib = jnp.where(_mask_col(mask), contrib, 0.0)
                        post = post.at[j].add(_col_align(contrib, s))
                        r[e] = rn[idx]
            outs.append(_from_blocks(post))
        return jnp.stack(outs)  # [T, B, n]

    return run


def soft_ber_loss(posteriors: jax.Array, bits: jax.Array) -> jax.Array:
    """Mean sigmoid cross-entropy of posterior LLR margins over all
    iteration outputs.  ``posteriors``: [T, B, n] (positive => bit 0);
    ``bits``: [B, n] true 0/1."""
    tgt = 1.0 - 2.0 * bits.astype(posteriors.dtype)  # +1 for bit 0
    return jnp.mean(jax.nn.softplus(-tgt[None] * posteriors))


@dataclasses.dataclass(frozen=True)
class LearnedWeights:
    """A trained weight schedule plus its conversion helpers."""

    alpha: np.ndarray          #: [T, n_layers]
    beta: np.ndarray           #: [T, n_layers]
    losses: Tuple[float, ...]  #: per-step training losses

    @property
    def n_iters(self) -> int:
        return self.alpha.shape[0]

    def config_values(self, per_layer: bool = False):
        """(normalization, offset) values for DecoderConfig.

        ``per_layer=True`` collapses the schedule to its iteration-mean —
        one static weight per layer, servable by the fused CUDA kernel;
        the default keeps the full per-iteration schedule (jnp path).
        """
        if per_layer:
            a = tuple(float(x) for x in self.alpha.mean(axis=0))
            b_l = self.beta.mean(axis=0)
            b = 0.0 if not b_l.any() else tuple(float(x) for x in b_l)
            return a, b
        a = tuple(tuple(float(x) for x in row) for row in self.alpha)
        if not self.beta.any():
            return a, 0.0
        return a, tuple(tuple(float(x) for x in row) for row in self.beta)

    def decoder_config(self, base=None, per_layer: bool = False, **overrides):
        """A DecoderConfig carrying this schedule (replace on ``base``)."""
        from ..utils.config import DecoderConfig

        a, b = self.config_values(per_layer)
        base = base if base is not None else DecoderConfig()
        return dataclasses.replace(
            base, normalization=a, offset=b, **overrides
        )


def train_nms(
    code: QCCode,
    *,
    n_iters: int = 8,
    steps: int = 200,
    batch: int = 128,
    snr_db: Tuple[float, float] = (1.0, 4.0),
    lr: float = 0.02,
    seed: int = 0,
    schedule: str = "layered",
    train_offset: bool = False,
    init_alpha: float = 0.75,
    init_beta: float = 0.0,
    encode_fn=None,
    log_every: int = 0,
    tie_iters: bool = False,
    reg_to_init: float = 0.0,
) -> LearnedWeights:
    """Train per-iteration x per-layer min-sum weights for ``code``.

    AWGN samples are drawn fresh each step with per-frame SNR uniform over
    ``snr_db`` (train across the waterfall, not one point); LLRs are the
    proper 2y/sigma^2.  ``encode_fn`` switches from all-zero-codeword
    training (exact for this symmetric decoder) to random codewords.
    Weights are projected to [0.05, 1] (alpha — normalized min-sum with
    alpha > 1 over-amplifies check messages and can stall syndrome
    clearance even when hard decisions look fine) / [0, 2] (beta) after
    each Adam step.  ``reg_to_init``: L2 pull toward the init — use on
    codes with many layers, where a modest training budget otherwise
    overfits noisy per-layer gradients.  Runs on whatever backend jax is
    configured for.
    """
    import optax

    run = make_unrolled(code, n_iters, schedule)
    n_layers = code.m_b
    # tie_iters trains ONE weight row shared by every iteration (the
    # per-layer form the fused kernels serve); the unrolled decoder
    # broadcasts a first dim of 1
    rows = 1 if tie_iters else n_iters
    params = {
        "alpha": jnp.full((rows, n_layers), init_alpha, jnp.float32),
        "beta": jnp.full((rows, n_layers), init_beta, jnp.float32),
    }
    opt = optax.adam(lr)
    opt_state = opt.init(params)
    lo, hi = snr_db

    def sample(key):
        kb, kn, ks = jax.random.split(key, 3)
        if encode_fn is None:
            cw = jnp.zeros((batch, code.n), jnp.float32)
        else:
            u = jax.random.bernoulli(
                kb, 0.5, (batch, code.k)
            ).astype(jnp.float32)
            cw = encode_fn(u).astype(jnp.float32)
        snr = jax.random.uniform(ks, (batch, 1), minval=lo, maxval=hi)
        sigma = 10.0 ** (-snr / 20.0)
        y = (1.0 - 2.0 * cw) + sigma * jax.random.normal(
            kn, (batch, code.n)
        )
        return 2.0 * y / jnp.square(sigma), cw

    @jax.jit
    def step(params, opt_state, key):
        llr, cw = sample(key)

        def loss_fn(p):
            if not train_offset:
                p = {"alpha": p["alpha"],
                     "beta": jax.lax.stop_gradient(p["beta"])}
            loss = soft_ber_loss(run(p, llr), cw)
            if reg_to_init:
                loss = loss + reg_to_init * (
                    jnp.mean(jnp.square(p["alpha"] - init_alpha))
                    + jnp.mean(jnp.square(p["beta"] - init_beta))
                )
            return loss

        loss, grads = jax.value_and_grad(loss_fn)(params)
        updates, opt_state = opt.update(grads, opt_state)
        params = optax.apply_updates(params, updates)
        params = {
            "alpha": jnp.clip(params["alpha"], 0.05, 1.0),
            "beta": jnp.clip(params["beta"], 0.0, 2.0),
        }
        return params, opt_state, loss

    key = jax.random.PRNGKey(seed)
    losses = []
    for i in range(steps):
        key, sub = jax.random.split(key)
        params, opt_state, loss = step(params, opt_state, sub)
        losses.append(float(loss))
        if log_every and (i + 1) % log_every == 0:
            print(f"[train_nms] step {i + 1}/{steps} loss {losses[-1]:.5f}")
    return LearnedWeights(
        alpha=np.asarray(params["alpha"]),
        beta=np.asarray(params["beta"]),
        losses=tuple(losses),
    )
