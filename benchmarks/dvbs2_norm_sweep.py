"""Sweep min-sum normalization/offset for DVB-S2 64800 r1/2 @1.4 dB.

Reports conv rate, mean iters, batch iterations (total_iters), info-bit
errors, and decode time per 1024-frame batch.
"""
import sys, time, dataclasses
sys.path.insert(0, __import__("os").path.dirname(__import__("os").path.dirname(__import__("os").path.abspath(__file__))))
import jax, jax.numpy as jnp, numpy as np
from myldpccppapi.codes.dvbs2 import dvbs2_ira_qc, ira_encode_numpy
from myldpccppapi.utils.config import DecoderConfig
from myldpccppapi.decoder import Decoder

code = dvbs2_ira_qc(64800, "1/2")
rng = np.random.default_rng(0)
batch = 1024
u = rng.integers(0, 2, size=(batch, code.k), dtype=np.uint8)
cw = ira_encode_numpy(code, u)
sigma = 10 ** (-1.4 / 20)
sym = jax.device_put(jnp.asarray(1.0 - 2.0 * cw.astype(np.float32)))
u_dev = jax.device_put(jnp.asarray(u, jnp.int8))

@jax.jit
def make_llr(s, key):
    noise = sigma * jax.random.normal(key, s.shape, jnp.float32)
    return 2.0 * (s + noise) / (sigma * sigma)

llrs = [make_llr(sym, jax.random.PRNGKey(i)) for i in range(4)]
jax.block_until_ready(llrs)

settings = [
    ("norm0.80", dict(normalization=0.8)),
    ("norm0.85", dict(normalization=0.85)),
    ("norm0.90", dict(normalization=0.9)),
    ("norm0.75", dict(normalization=0.75)),
    ("offs0.15", dict(normalization=1.0, offset=0.15)),
]

for name, kw in settings:
    dec = Decoder(code, DecoderConfig(schedule="layered", max_iters=30, **kw))

    @jax.jit
    def run(llr):
        res = dec(llr)
        berr = jnp.sum((res.bits[:, :code.k].astype(jnp.int8)
                        != u_dev).astype(jnp.int32))
        return (jnp.sum(res.iterations), jnp.sum(res.converged),
                berr, res.total_iters)

    out = run(llrs[0]); jax.block_until_ready(out)
    times = []
    for llr in llrs[1:]:
        t0 = time.perf_counter()
        out = run(llr)
        jax.block_until_ready(out)
        times.append(time.perf_counter() - t0)
    dt = sorted(times)[len(times) // 2]
    it, cv, be, tmax = (int(x) for x in out)
    mb = batch * code.k / dt / 1e6
    print(f"{name}: conv={cv/batch:.4f} mean_iters={it/batch:5.2f} "
          f"bit_err={be} t={dt*1e3:6.1f}ms -> {mb:6.1f} Mbit/s", flush=True)
