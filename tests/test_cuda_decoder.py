"""The fused CUDA min-sum decoder (ops/cuda_bp.py + cuda/minsum_decoder.cu).

Three kinds of test:

* host-side pieces the CPU reaches: base-graph tables, weights, launch
  geometry, refusals, and the one platform dispatch
  (``decoder.select_implementation``) with the platform monkeypatched;
* the kernel's own source run on the host under a thread-per-CUDA-thread
  emulation (tests/cuda_emu), compared bit for bit with ops/bp.py;
* ``gpu``-marked tests of the compiled kernel, skipped without a card and
  run on it by ``python chip_smoke.py``.
"""
import os
import shutil
import subprocess

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from myldpccppapi import DecoderConfig, Encoder, wimax
from myldpccppapi.codes import encode_numpy, nr_code, regular
from myldpccppapi.codes.qc import QCCode
from myldpccppapi.codes.wifi import wifi
from myldpccppapi.ops import cuda_bp
from myldpccppapi.ops.bp import decode_qc
from myldpccppapi.ops.channel import transmit

_REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
_EMU = os.path.join(_REPO, "tests", "cuda_emu")


def _w1row():
    """A base graph with a degree-1 row (the excluding-self clamp path)."""
    base = np.array([[1, 3, 0, -1], [2, 0, -1, 0], [-1, -1, 5, -1]], np.int32)
    return QCCode(name="w1row", base=base, z=8)


def _noisy(code, frames, snr_db, seed=0):
    rng = np.random.default_rng(seed)
    u = rng.integers(0, 2, (frames, code.k_info), dtype=np.uint8)
    c = encode_numpy(Encoder(code).mats, u)
    llr, _ = transmit(jax.random.PRNGKey(seed + 1), jnp.asarray(c),
                      snr_db=snr_db)
    return np.asarray(llr, np.float32)


def _fake_platform(monkeypatch, platform):
    import myldpccppapi.decoder as decoder_mod

    class _Dev:
        pass

    dev = _Dev()
    dev.platform = platform
    monkeypatch.setattr(decoder_mod.jax, "devices", lambda *a: [dev])


# ---------------------------------------------------------------------------
# tables, weights, geometry
# ---------------------------------------------------------------------------

_TABLE_CODES = {
    "wimax576_r34B": lambda: wimax(576, "3/4B"),
    "wimax2304_r12": lambda: wimax(2304, "1/2"),
    "wifi1944_r56": lambda: wifi(1944, "5/6"),
    "regular648": lambda: regular(648),
    "nr_bg2_z32": lambda: nr_code(z=32, bg=2),
}


@pytest.mark.parametrize("name", sorted(_TABLE_CODES))
def test_kernel_tables_match_h_coo(name):
    """The kernel's (layer, edge column, shift) table spans exactly the
    Tanner graph of ``code.h_coo()``, and its column lists hold every edge
    once, grouped by block column in ascending edge order."""
    code = _TABLE_CODES[name]()
    tab = cuda_bp.kernel_tables(code)
    m_b, n_b, e = code.m_b, code.n_b, code.num_blocks
    layer_ptr = tab[: m_b + 1]
    col = tab[m_b + 1: m_b + 1 + e]
    shift = tab[m_b + 1 + e: m_b + 1 + 2 * e]
    col_ptr = tab[m_b + 1 + 2 * e: m_b + 2 * e + n_b + 2]
    col_edge = tab[m_b + 2 * e + n_b + 2: m_b + 3 * e + n_b + 2]
    edge_layer = tab[m_b + 3 * e + n_b + 2:]
    assert len(edge_layer) == e
    z, r = code.z, np.arange(code.z)
    rows, cols = [], []
    for li in range(m_b):
        for k in range(layer_ptr[li], layer_ptr[li + 1]):
            assert edge_layer[k] == li
            rows.append(li * z + r)
            cols.append(col[k] * z + (r + shift[k]) % z)
    got = sorted(zip(np.concatenate(rows).tolist(),
                     np.concatenate(cols).tolist()))
    h_rows, h_cols = code.h_coo()
    assert got == sorted(zip(h_rows.tolist(), h_cols.tolist()))
    assert sorted(col_edge.tolist()) == list(range(e))
    for j in range(n_b):
        members = col_edge[col_ptr[j]: col_ptr[j + 1]]
        assert (col[members] == j).all()
        assert (np.diff(members) > 0).all()


def test_kernel_weights_scalar_and_per_layer():
    w = cuda_bp.kernel_weights(DecoderConfig(normalization=0.75, offset=0.1), 3)
    np.testing.assert_array_equal(
        w, np.float32([0.75, 0.75, 0.75, 0.1, 0.1, 0.1]))
    w = cuda_bp.kernel_weights(DecoderConfig(normalization=(0.7, 0.8)), 2)
    np.testing.assert_array_equal(w, np.float32([0.7, 0.8, 0.0, 0.0]))
    with pytest.raises(ValueError, match="per-iteration"):
        cuda_bp.kernel_weights(DecoderConfig(normalization=((0.7, 0.8),)), 2)


@pytest.mark.parametrize("name", sorted(_TABLE_CODES))
def test_frames_per_block_fits_a_block(name):
    """One thread per check row of each codeword: the block stays within
    1024 threads and the shared-memory limit, and near 256 threads."""
    code = _TABLE_CODES[name]()
    g = cuda_bp.frames_per_block(code)
    assert g >= 1
    assert g * code.z <= 1024
    assert cuda_bp.smem_bytes(code, g) <= cuda_bp.SMEM_LIMIT
    assert g == 1 or (g - 1) * code.z < 256
    # the layout grows with every codeword the block holds
    assert cuda_bp.smem_bytes(code, g + 1) > cuda_bp.smem_bytes(code, g)


def test_frames_per_block_zero_when_one_codeword_overflows():
    code = nr_code(z=384, bg=1)
    assert cuda_bp.frames_per_block(code) == 0
    assert "shared memory" in cuda_bp.unsupported_reason(code, DecoderConfig())


# ---------------------------------------------------------------------------
# refusals and dispatch
# ---------------------------------------------------------------------------

_REFUSALS = {
    "sum-product": (lambda: wimax(576, "1/2"),
                    DecoderConfig(algorithm="sum-product"), "sum-product"),
    "scms": (lambda: wimax(576, "1/2"),
             DecoderConfig(schedule="flooding", self_correction=True), "SCMS"),
    "soft": (lambda: wimax(576, "1/2"), DecoderConfig(soft_output=True),
             "soft_output"),
    "bf16": (lambda: wimax(576, "1/2"), DecoderConfig(msg_dtype="bfloat16"),
             "bfloat16"),
    "iter_weights": (lambda: wimax(576, "1/2"),
                     DecoderConfig(normalization=((0.7,), (0.8,))),
                     "per-iteration"),
    "masked": (lambda: __import__("myldpccppapi.codes.dvbs2",
                                  fromlist=["dvbs2"]).dvbs2(16200, "1/2"),
               DecoderConfig(), "masked"),
    "xor": (lambda: __import__("myldpccppapi.codes.rs_ldpc",
                               fromlist=["rs_ldpc_from_n"]).rs_ldpc_from_n(2048),
            DecoderConfig(), "XOR"),
    "multi_edge": (lambda: QCCode(name="me", base=np.array(
        [[0, 1, 0, -1], [2, -1, 0, 0]], np.int32), z=8,
        extra_blocks=((0, 1, 5),)), DecoderConfig(), "twice"),
    "row_degree": (lambda: QCCode(name="dense", base=np.zeros((1, 40), np.int32),
                                  z=4), DecoderConfig(), "row degree"),
    "no_blocks": (lambda: type("Plain", (), {"n": 8, "m": 4})(),
                  DecoderConfig(), "block structure"),
}


@pytest.mark.parametrize("case", sorted(_REFUSALS))
def test_unsupported_reasons(case):
    make, cfg, match = _REFUSALS[case]
    reason = cuda_bp.unsupported_reason(make(), cfg)
    assert reason is not None and match in reason


def test_supported_headline_and_flooding_configs():
    for code in (wimax(576, "3/4B"), wifi(1944, "5/6"), _w1row()):
        for cfg in (DecoderConfig(schedule="layered", normalization=0.75),
                    DecoderConfig(schedule="flooding", max_iters=120),
                    DecoderConfig(normalization=(0.7,) * code.m_b,
                                  offset=0.05, crc=None)):
            assert cuda_bp.unsupported_reason(code, cfg) is None


_DISPATCH = [
    # (case, platform, code, cfg, expected implementation)
    ("headline_gpu", "gpu", lambda: wimax(576, "3/4B"),
     DecoderConfig(normalization=0.75, triage_iters=5), "cuda"),
    ("headline_cpu", "cpu", lambda: wimax(576, "3/4B"),
     DecoderConfig(normalization=0.75, triage_iters=5), "jnp"),
    ("flooding_gpu", "gpu", lambda: wifi(1944, "5/6"),
     DecoderConfig(schedule="flooding"), "cuda"),
    ("crc_gpu", "gpu", lambda: wimax(576, "1/2"),
     DecoderConfig(crc="16"), "cuda"),
    ("long_nr_gpu", "gpu", lambda: nr_code(z=384, bg=1),
     DecoderConfig(normalization=0.8), "jnp"),
    ("dvbs2_gpu", "gpu", lambda: __import__(
        "myldpccppapi.codes.dvbs2", fromlist=["dvbs2"]).dvbs2(16200, "1/2"),
     DecoderConfig(), "jnp"),
    ("scms_gpu", "gpu", lambda: wimax(576, "1/2"),
     DecoderConfig(schedule="flooding", self_correction=True), "jnp"),
    ("soft_gpu", "gpu", lambda: wimax(576, "1/2"),
     DecoderConfig(soft_output=True), "jnp"),
    ("sum_product_gpu", "gpu", lambda: wimax(576, "1/2"),
     DecoderConfig(algorithm="sum-product"), "jnp"),
    ("no_blocks_gpu", "gpu", lambda: type("Plain", (), {"n": 8, "m": 4})(),
     DecoderConfig(), "edgelist"),
    ("no_blocks_cpu", "cpu", lambda: type("Plain", (), {"n": 8, "m": 4})(),
     DecoderConfig(), "edgelist"),
    ("explicit_jnp_gpu", "gpu", lambda: wimax(576, "3/4B"),
     DecoderConfig(implementation="jnp"), "jnp"),
]


@pytest.mark.parametrize("case,platform,make,cfg,expected", _DISPATCH,
                         ids=[d[0] for d in _DISPATCH])
def test_select_implementation(monkeypatch, case, platform, make, cfg,
                               expected):
    from myldpccppapi.decoder import select_implementation

    _fake_platform(monkeypatch, platform)
    assert select_implementation(make(), cfg) == expected


def test_decoder_builds_cuda_path_on_gpu(monkeypatch):
    """The Decoder facade wires the kernel (with its triage and CRC
    wrappers) when dispatch picks it; nothing runs until the first call."""
    from myldpccppapi import Decoder

    _fake_platform(monkeypatch, "gpu")
    dec = Decoder(wimax(576, "1/2"), DecoderConfig(crc="16", triage_iters=4))
    assert dec.implementation == "cuda"


def test_explicit_cuda_raises_without_gpu():
    from myldpccppapi import Decoder

    with pytest.raises(ValueError, match="needs a GPU"):
        Decoder(wimax(576, "3/4B"), DecoderConfig(implementation="cuda"))


def test_explicit_cuda_refuses_unsupported_config(monkeypatch):
    from myldpccppapi import Decoder

    _fake_platform(monkeypatch, "gpu")
    with pytest.raises(ValueError, match="soft_output"):
        Decoder(wimax(576, "1/2"),
                DecoderConfig(implementation="cuda", soft_output=True))


# ---------------------------------------------------------------------------
# the kernel source under host emulation
# ---------------------------------------------------------------------------

@pytest.fixture(scope="module")
def emulated_kernel(tmp_path_factory):
    """Compile minsum_decoder.cu's kernel with g++ against the emulation
    header; returns a decode(code, cfg, llr, frames) callable."""
    cxx = shutil.which("g++")
    if cxx is None:
        pytest.skip("g++ is needed to build the kernel emulation")
    build = tmp_path_factory.mktemp("cuda_emu")
    src = open(os.path.join(_REPO, "myldpccppapi", "cuda",
                            "minsum_decoder.cu")).read()
    src = src[: src.index("ffi::Error MinSumDecodeImpl")] + "}  // namespace\n"
    src = src.replace("extern __shared__ __align__(16) unsigned char smem[];",
                      "unsigned char* smem = g_smem;")
    (build / "kernel.inc").write_text(src)
    exe = build / "harness"
    subprocess.run(
        [cxx, "-std=c++20", "-O1", "-pthread", "-I", str(build), "-I", _EMU,
         "-I", jax.ffi.include_dir(), "-o", str(exe),
         os.path.join(_EMU, "harness.cpp")],
        check=True, capture_output=True, timeout=300)

    def decode(code, cfg, llr, frames=None):
        frames = frames or cuda_bp.frames_per_block(code)
        llr = np.ascontiguousarray(llr, np.float32)
        llr.tofile(build / "llr.bin")
        cuda_bp.kernel_tables(code).tofile(build / "tab.bin")
        cuda_bp.kernel_weights(cfg, code.m_b).tofile(build / "w.bin")
        b = llr.shape[0]
        subprocess.run(
            [str(exe), str(build), str(code.z), str(code.n_b), str(code.m_b),
             str(code.num_blocks), str(frames), str(cfg.max_iters),
             str(int(cfg.schedule == "layered")), str(b)],
            check=True, timeout=300)
        bits = np.fromfile(build / "bits.out", np.uint8).reshape(b, code.n)
        iters = np.fromfile(build / "iters.out", np.int32)
        conv = np.fromfile(build / "conv.out", np.uint8) > 0
        return bits, iters, conv

    return decode


_EMU_CASES = {
    # the headline config at a mixed-convergence point
    "wimax576_r34B_layered_nms": (lambda: wimax(576, "3/4B"), DecoderConfig(
        schedule="layered", normalization=0.75, max_iters=12), 4.0, 24, None),
    # the reference's MS / MSCL type: plain flooding min-sum
    "wimax576_r12_flooding_ms": (lambda: wimax(576, "1/2"), DecoderConfig(
        schedule="flooding", max_iters=15), 2.0, 20, None),
    # offset + normalization, partial last block (19 frames, 3 per block)
    "wimax576_r12_offset_partial_block": (lambda: wimax(576, "1/2"),
        DecoderConfig(schedule="layered", normalization=0.8, offset=0.1,
                      max_iters=12), 2.0, 19, 3),
    # per-layer weights on flooding
    "wifi648_r56_flooding_per_layer": (lambda: wifi(648, "5/6"),
        DecoderConfig(schedule="flooding",
                      normalization=(0.7, 0.75, 0.8, 0.85), max_iters=10),
        5.0, 12, None),
    # the flooding face-off shape's code, one block of 3
    "wifi1944_r56_flooding": (lambda: wifi(1944, "5/6"), DecoderConfig(
        schedule="flooding", normalization=0.75, max_iters=8), 4.5, 3, None),
    # degree-1 check row (clamped excluding-self magnitude)
    "w1row_layered": (_w1row, DecoderConfig(schedule="layered", max_iters=8),
                      None, 10, 4),
    # no early exit: converged frames stay latched
    "regular648_no_early_exit": (lambda: regular(648), DecoderConfig(
        schedule="layered", normalization=0.8, max_iters=6,
        early_exit=False), 3.0, 6, None),
}


@pytest.mark.parametrize("case", sorted(_EMU_CASES))
def test_emulated_kernel_matches_jnp_bitexact(emulated_kernel, case):
    """The kernel's arithmetic and schedule reproduce ops/bp.py exactly:
    bits, convergence and iteration counts of every frame (the card may
    differ only where the GPU compiler contracts a multiply-add, which the
    build disables with -fmad=false)."""
    make, cfg, snr, frames_n, per_block = _EMU_CASES[case]
    code = make()
    if snr is None:
        llr = np.random.default_rng(3).normal(1.0, 1.5, (frames_n, code.n))
        llr = llr.astype(np.float32)
    else:
        llr = _noisy(code, frames_n, snr)
    bits, iters, conv = emulated_kernel(code, cfg, llr, per_block)
    ref = decode_qc(code, cfg, jnp.asarray(llr))
    np.testing.assert_array_equal(iters, np.asarray(ref.iterations))
    np.testing.assert_array_equal(conv, np.asarray(ref.converged))
    np.testing.assert_array_equal(bits, np.asarray(ref.bits))
    if conv.any():
        assert not code.syndrome(bits[conv]).any()


# ---------------------------------------------------------------------------
# the compiled kernel on the card
# ---------------------------------------------------------------------------

def _golden(code, cfg, llr):
    from myldpccppapi import native

    fn = (native.decode_golden_layered_native if cfg.schedule == "layered"
          else native.decode_golden_flooding_native)
    out = fn(code, llr, max_iters=cfg.max_iters,
             normalization=cfg.normalization, offset=cfg.offset)
    assert out is not None, "the native golden decoder must build"
    return out


@pytest.mark.gpu
@pytest.mark.parametrize("schedule", ["layered", "flooding"])
def test_cuda_matches_native_golden(gpu, schedule):
    """Compiled kernel vs the C++ golden decoder at a mixed-convergence
    point: hard bits equal on frames both converged, iteration counts equal
    on at least 99% of frames."""
    code = wimax(576, "3/4B") if schedule == "layered" else wifi(1944, "5/6")
    cfg = DecoderConfig(schedule=schedule, normalization=0.75, max_iters=20,
                        implementation="cuda")
    llr = _noisy(code, 256, 3.5 if schedule == "layered" else 5.5)
    res = cuda_bp.decode_qc_cuda(code, cfg, jnp.asarray(llr))
    gb, gc, gi = _golden(code, cfg, llr)
    bits, conv, iters = (np.asarray(res.bits), np.asarray(res.converged),
                         np.asarray(res.iterations))
    both = conv & gc
    assert both.any()
    np.testing.assert_array_equal(bits[both], gb[both])
    assert np.mean(iters == gi) >= 0.99


@pytest.mark.gpu
def test_cuda_partial_block(gpu):
    """A batch that is no multiple of the block's codewords gives the jnp
    path's per-frame results, and batch 0 is accepted."""
    code = wimax(576, "1/2")
    cfg = DecoderConfig(schedule="layered", normalization=0.8, max_iters=12)
    assert 37 % cuda_bp.frames_per_block(code)
    llr = jnp.asarray(_noisy(code, 37, 2.0))
    ref = decode_qc(code, cfg, llr)
    res = cuda_bp.decode_qc_cuda(code, cfg, llr)
    assert np.mean(np.asarray(res.iterations)
                   == np.asarray(ref.iterations)) >= 0.99
    ok = np.asarray(res.converged) & np.asarray(ref.converged)
    assert ok.any()
    np.testing.assert_array_equal(np.asarray(res.bits)[ok],
                                  np.asarray(ref.bits)[ok])
    empty = cuda_bp.decode_qc_cuda(code, cfg, llr[:0])
    assert empty.bits.shape == (0, code.n)


@pytest.mark.gpu
def test_cuda_decoder_facade_triage_and_crc(gpu):
    """Auto dispatch picks the kernel on the card, under the triage and
    CRC-acceptance wrappers, and decodes clean frames."""
    from myldpccppapi import Decoder
    from myldpccppapi.parallel.sim import sim_step

    code = wimax(576, "1/2")
    cfg = DecoderConfig(normalization=0.75, triage_iters=4, crc="16")
    dec = Decoder(code, cfg)
    assert dec.implementation == "cuda"
    stats = jax.jit(lambda k: sim_step(code, cfg, k, 4.0, 512, decode_fn=dec))(
        jax.random.PRNGKey(0))
    assert int(stats.undetected_errors) == 0
    assert int(stats.frame_errors) <= int(stats.unconverged) + int(
        stats.crc_rejected)
