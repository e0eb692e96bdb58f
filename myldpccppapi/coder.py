"""Byte-stream ``Coder`` facade, API-compatible with the reference.

Mirrors the public surface of the reference's ``class Coder``
(``MyLdpc.h:104-127``): the arming methods (``for_encoder`` /
``for_decoder(batch)`` / ``add_decode_type``), the streaming ``encode`` /
``decode`` over packed byte buffers (LSB-first bit packing, zero-padded final
block), the AWGN self-test ``test``, and the size-query contract
(``getPriorCodeLength/getPostCodeLength/getCodeSize``, ``MyLdpc.cpp:620-631``).

Decode-type names map onto decoder configurations instead of separate device
buffer/kernel plumbing:

==========  =====================================================
reference    here
==========  =====================================================
DecodeCPU    numpy golden flooding min-sum (ops/golden.py)
DecodeMS     flooding min-sum (jnp/XLA while_loop)
DecodeSP     flooding sum-product (log domain)
DecodeTDMP   layered min-sum
DecodeMSCL   flooding min-sum, fused CUDA kernel when available
DecodeTDMPCL layered min-sum, fused CUDA kernel when available
(no equiv)   BF: multi-flip noisy GDBF (ops/bitflip.py) — the
             message-free bit-flipping tier below BP
==========  =====================================================
"""
from __future__ import annotations

import numpy as np
import jax
import jax.numpy as jnp

from .codes.encoder import Encoder, encode_numpy, ru_precompute
from .codes.wimax import wimax
from .decoder import Decoder
from .ops import golden
from .ops.channel import awgn, bpsk_modulate
from .ops.bitflip import GDBFConfig
from .ops.packing import pack_bits_np, unpack_bits_np
from .utils.config import DecoderConfig

__all__ = ["Coder", "DECODE_TYPES", "make_codec"]


def make_codec(family: str, n: int | None = None, rate: str = "1/2", *,
               z: int | None = None, bg: int = 1,
               max_iters: int = 40, crc: str | None = None) -> "Coder":
    """Byte-stream :class:`Coder` for any supported code family.

    ==========  ==============================================  ===========
    family       code construction                               encoder
    ==========  ==============================================  ===========
    "wimax"      802.16e, ``n`` in {576..2304}, 6 rate tables    RU / int8 matmul
    "wifi"       802.11n, ``n`` in {648, 1296, 1944}, 4 rates    RU / int8 matmul
    "regular"    array-construction (3,6), any ``n`` mult. 6     information-set
    "nr"         5G NR BG1/BG2 at lifting ``z``                  triangular back-subst.
    "dvbs2"      EN 302 307 IRA structure, n=64800/16200         accumulator prefix-XOR
    "rs_ldpc"    802.3an-class RS-based, ``n`` = 32 * 2^s        information-set
    ==========  ==============================================  ===========

    The byte-stream semantics (chunking, LSB-first packing, size queries,
    ``test``/``decode``) are identical across families; 802.16e behavior is
    exactly the reference's (``MyLdpc.cpp:554-618``).
    """
    family = family.lower()
    if family == "wimax":
        n = n or 576
        code = wimax(n, rate)
        return Coder(code.k, n, rate, max_iters=max_iters, crc=crc)
    if family == "wifi":
        from .codes.wifi import wifi

        code = wifi(n or 1296, rate)
        return Coder(code=code, max_iters=max_iters, crc=crc)
    if family == "regular":
        from .codes.regular import regular

        return Coder(code=regular(n or 648), max_iters=max_iters, crc=crc)
    if family == "nr":
        from .codes.nr import nr_code, triangular_encode_fn, triangular_encode_numpy

        code = nr_code(z=z or 384, bg=bg)
        enc_np = lambda u: triangular_encode_numpy(code, u)
        return Coder(code=code, max_iters=max_iters, crc=crc,
                     encoders=(enc_np, triangular_encode_fn(code)))
    if family == "dvbs2":
        from .codes.dvbs2 import dvbs2_ira_qc, ira_encode_fn, ira_encode_numpy

        code = dvbs2_ira_qc(n or 64800, rate)
        enc_np = lambda u: ira_encode_numpy(code, u)
        return Coder(code=code, max_iters=max_iters, crc=crc,
                     encoders=(enc_np, ira_encode_fn(code)))
    if family == "rs_ldpc":
        from .codes.rs_ldpc import rs_ldpc_from_n

        if rate != "1/2":
            # the construction fixes the rate (0.841 for n=2048): a caller
            # asking for a specific rate must not silently get another
            raise ValueError(
                "rs_ldpc's rate is fixed by the (gamma, rho) construction "
                "(0.841 at n=2048); omit rate"
            )
        return Coder(code=rs_ldpc_from_n(n or 2048), max_iters=max_iters,
                     crc=crc)
    raise ValueError(
        f"unknown family {family!r}; choose from wimax, wifi, regular, nr, "
        "dvbs2, rs_ldpc"
    )

DECODE_TYPES = {
    "CPU": None,
    "MS": DecoderConfig(algorithm="min-sum", schedule="flooding", implementation="jnp"),
    "SP": DecoderConfig(algorithm="sum-product", schedule="flooding", implementation="jnp"),
    "TDMP": DecoderConfig(algorithm="min-sum", schedule="layered", implementation="jnp"),
    "MSCL": DecoderConfig(algorithm="min-sum", schedule="flooding", max_iters=120,
                          implementation="auto"),
    "TDMPCL": DecoderConfig(algorithm="min-sum", schedule="layered", implementation="auto"),
    # bit-flipping tier (no reference equivalent): multi-flip noisy GDBF,
    # message-free state.  Keeps its own (cheap) 100-flip budget like MSCL
    # keeps its 120-iteration cap.
    "BF": GDBFConfig(max_iters=100),
    # self-corrected min-sum (Savin 2008; no reference equivalent):
    # sign-flip erasure instead of a tuned correction constant (jnp path)
    "SCMS": DecoderConfig(algorithm="min-sum", schedule="flooding",
                          self_correction=True, implementation="auto"),
}


class Coder:
    """Byte-stream LDPC codec.

    ``Coder(k, n, rate)`` is the reference-compatible 802.16e constructor
    (``rate`` in "1/2", "2/3A", "2/3B", "3/4A", "3/4B", "5/6"); any other
    code family plugs in via :func:`make_codec`, which picks the right
    encoder (RU/int8 matmul, triangular back-substitution, or IRA
    accumulator) per family.

    Streaming contract: the byte stream is chunked into ``k_info // 8``
    bytes per codeword (trailing info bits of a non-byte-aligned k — e.g.
    802.11n n=648 rate 1/2, k=324 — are always zero).  With ``crc`` set,
    the last L info bits carry the CRC (TS 38.212 §5.1 code-block layout):
    ``encode`` attaches it, payload chunking shrinks to
    ``(k_info - L) // 8`` bytes per codeword, and ``decode`` requires
    syndrome AND CRC for acceptance (stats report the split).
    """

    def __init__(self, ldpc_k: int | None = None, ldpc_n: int | None = None,
                 rate: str | None = None, max_iters: int = 40, *,
                 code=None, encoders=None, crc: str | None = None):
        if code is None:
            code = wimax(ldpc_n, rate)
            if code.k != ldpc_k:
                raise ValueError(
                    f"k={ldpc_k} inconsistent with n={ldpc_n} rate={rate} "
                    f"(expected k={code.k})"
                )
        self.code = code
        #: optional (numpy_fn, jnp_fn) pair: info bits [ncw, k_info] -> full
        #: codeword [ncw, n]; None = RU / generic information-set encoder
        self._custom_encoders = encoders
        self.crc = crc
        self._crc_len = 0
        if crc is not None:
            from .codes.crc import CRC_POLYS

            if crc not in CRC_POLYS:
                raise ValueError(
                    f"unknown crc {crc!r}; choose from {sorted(CRC_POLYS)}"
                )
            self._crc_len = CRC_POLYS[crc][0]
            if self.code.k_info <= self._crc_len + 8:
                raise ValueError(
                    f"CRC{crc} leaves no payload in k_info={self.code.k_info}"
                )
        self._kb = (self.code.k_info - self._crc_len) // 8
        self.max_iters = max_iters
        self._encoder: Encoder | None = None
        self._encode_np = None
        self._encode_jit = None
        self._decoders: dict[str, Decoder] = {}
        self.batch_size = 0

    # -- arming ------------------------------------------------------------
    def for_encoder(self) -> None:
        if self._custom_encoders is not None:
            self._encode_np, enc_j = self._custom_encoders
            self._encode_jit = jax.jit(enc_j) if enc_j is not None else None
        else:
            self._encoder = Encoder(self.code)

    def for_decoder(self, batch_size: int) -> None:
        self.batch_size = int(batch_size)

    def add_decode_type(self, de_type: str) -> None:
        if de_type not in DECODE_TYPES:
            raise ValueError(f"unknown decode type {de_type!r}; choose from {sorted(DECODE_TYPES)}")
        if de_type == "CPU":
            return
        import dataclasses

        cfg = DECODE_TYPES[de_type]
        if cfg.max_iters != self.max_iters and de_type not in ("MSCL", "BF"):
            cfg = dataclasses.replace(cfg, max_iters=self.max_iters)
        if de_type == "MSCL":
            cfg = self._resolve_mscl(cfg)
        if self.crc is not None:
            if de_type == "BF":
                raise ValueError(
                    "CRC-aided acceptance is a BP-path feature; GDBF (BF) "
                    "has no in-loop integrity latch"
                )
            cfg = dataclasses.replace(cfg, crc=self.crc)
        self._decoders[de_type] = Decoder(self.code, cfg)

    def _resolve_mscl(self, cfg: DecoderConfig) -> DecoderConfig:
        """MSCL names the reference's FUSED flooding min-sum kernel
        (``decodeOnceMS``, ``decodeCL.c:432-567``; type table
        ``MyLdpc.h:37-39``): the whole decode in one kernel.  The fused
        CUDA kernel (ops/cuda_bp.py) serves it where it supports the code;
        elsewhere the decode runs on the jnp flooding path, and a warning
        says so rather than letting a fused-kernel request land there
        silently."""
        import warnings

        from .decoder import select_implementation

        if select_implementation(self.code, cfg) != "cuda":
            warnings.warn(
                f"MSCL on {self.code.name} (n={self.code.n}): no fused "
                "kernel supports this code on this platform; decoding on "
                "the jnp/XLA flooding path (correct, but not the "
                "single-kernel path MSCL names).",
                stacklevel=3,
            )
        return cfg

    # -- size queries (same rounding contract as MyLdpc.cpp:620-631) -------
    def get_code_size(self, src_length: int) -> int:
        kb = self._kb
        return (src_length + kb - 1) // kb

    def get_prior_code_length(self, src_length: int) -> int:
        return self.get_code_size(src_length) * (self.code.n // 8)

    def get_post_code_length(self, src_length: int) -> int:
        return self.get_code_size(src_length) * self.code.n

    # -- streaming ----------------------------------------------------------
    def encode(self, src: bytes | np.ndarray) -> np.ndarray:
        """Packed source bytes -> packed codeword bytes (uint8 array).

        The stream is chunked into k/8-byte blocks; the final partial block
        is zero-padded (reference: ``MyLdpc.cpp:554-569,661-662``).
        """
        if self._encoder is None and self._encode_np is None:
            raise RuntimeError("call for_encoder() first")
        src = np.frombuffer(bytes(src), dtype=np.uint8) if isinstance(src, (bytes, bytearray)) else np.asarray(src, dtype=np.uint8)
        kb = self._kb
        ncw = self.get_code_size(len(src))
        padded = np.zeros(ncw * kb, dtype=np.uint8)
        padded[: len(src)] = src
        info_bits = unpack_bits_np(padded.reshape(ncw, kb))  # [ncw, kb*8]
        k_info = self.code.k_info
        k_msg = k_info - self._crc_len
        if k_msg > kb * 8:  # non-byte-aligned k: trailing message bits are 0
            info_bits = np.concatenate(
                [info_bits,
                 np.zeros((ncw, k_msg - kb * 8), dtype=info_bits.dtype)],
                axis=1,
            )
        if self.crc is not None:
            # attach the CRC field (last L info bits, 38.212 layout)
            from .codes.crc import crc_matrix

            par = (info_bits.astype(np.int64)
                   @ crc_matrix(k_msg, self.crc).astype(np.int64)) & 1
            info_bits = np.concatenate(
                [info_bits, par.astype(info_bits.dtype)], axis=1
            )
        if self._encode_np is not None:
            if ncw < 256 or self._encode_jit is None:
                cw = np.asarray(self._encode_np(info_bits))
            else:
                cw = np.asarray(self._encode_jit(jnp.asarray(info_bits)))
        elif ncw < 256:
            # small streams: the host matmul beats paying an accelerator
            # compile for a one-shot encode
            cw = encode_numpy(self._encoder.mats, info_bits)
        else:
            cw = np.asarray(self._encoder(jnp.asarray(info_bits)))  # [ncw, n]
        return pack_bits_np(cw.astype(np.uint8)).reshape(-1)

    def test(self, prior_code: np.ndarray, sigma: float, seed: int = 0) -> np.ndarray:
        """BPSK + AWGN over a packed codeword stream -> soft values [len*8].

        Matches ``Coder::test`` (``MyLdpc.cpp:1061-1078``): bit 1 -> -1.0,
        bit 0 -> +1.0, Gaussian noise of std ``sigma`` (JAX PRNG instead of
        the reference's rand()-based Box-Muller).
        """
        bits = unpack_bits_np(np.asarray(prior_code, dtype=np.uint8))
        y = awgn(jax.random.PRNGKey(seed), bpsk_modulate(jnp.asarray(bits)), sigma)
        return np.asarray(y, dtype=np.float32)

    def decode(
        self,
        post_code: np.ndarray,
        src_length: int,
        de_type: str = "TDMP",
        llr_scale: float | None = None,
        return_stats: bool = False,
    ):
        """Soft stream [ncw*n] -> decoded source bytes [src_length].

        Like the reference, the raw channel value is fed to min-sum as the
        LLR (min-sum is scale-invariant).  Sum-product is *not* scale
        invariant; the reference bakes in the channel scale 8 = 2/sigma^2 for
        sigma^2 = 0.25 (``decodeCL.c:9``) — we reproduce that default for SP
        and let callers pass a calibrated ``llr_scale = 2/sigma^2`` instead.
        """
        if src_length == 0:
            # symmetric with encode(b"") -> empty output
            decoded = np.zeros(0, dtype=np.uint8)
            if return_stats:
                return decoded, {"converged": np.zeros(0, bool),
                                 "iterations": np.zeros(0, np.int32),
                                 "mean_iters": 0.0}
            return decoded
        post = np.asarray(post_code, dtype=np.float32).reshape(-1, self.code.n)
        if llr_scale is None:
            llr_scale = 8.0 if de_type == "SP" else 1.0
        if llr_scale != 1.0:
            post = post * np.float32(llr_scale)
        ncw = self.get_code_size(src_length)
        if post.shape[0] != ncw:
            raise ValueError(f"expected {ncw} codewords, got {post.shape[0]}")
        if de_type == "CPU":
            from . import native

            out = native.decode_golden_native(self.code, post, max_iters=self.max_iters)
            if out is None:
                out = golden.decode_golden(self.code, post, max_iters=self.max_iters)
            bits, conv, iters = out
            accepted = None
            if self.crc is not None:
                # the golden decoder has no in-loop CRC; acceptance is the
                # post-hoc syndrome AND CRC (no continuation)
                accepted = conv & self._crc_ok_np(bits)
        else:
            if de_type not in self._decoders:
                self.add_decode_type(de_type)
            dec = self._decoders[de_type]
            batch = self.batch_size or ncw
            outs, convs, iterss, accs = [], [], [], []
            for off in range(0, ncw, batch):
                chunk = post[off : off + batch]
                res = dec(jnp.asarray(chunk))
                outs.append(np.asarray(res.bits))
                convs.append(np.asarray(res.converged))
                iterss.append(np.asarray(res.iterations))
                accs.append(np.asarray(res.ok))
            bits = np.concatenate(outs, axis=0)
            conv = np.concatenate(convs)
            iters = np.concatenate(iterss)
            accepted = np.concatenate(accs) if self.crc is not None else None
        pos = np.asarray(self.code.info_positions)[: self._kb * 8]
        packed = pack_bits_np(bits[:, pos]).reshape(-1)
        decoded = packed[:src_length]
        if return_stats:
            # per-codeword convergence + iteration counts (the reference
            # prints "Time=<iters>" per batch, MyLdpc.cpp:838,966,1048)
            stats = {
                "converged": conv,
                "iterations": iters,
                "mean_iters": float(np.mean(iters)),
            }
            if accepted is not None:
                stats["accepted"] = accepted
                stats["crc_rejected"] = int(np.sum(conv & ~accepted))
            return decoded, stats
        return decoded

    def _crc_ok_np(self, bits: np.ndarray) -> np.ndarray:
        """[ncw, n] hard bits -> bool[ncw] CRC consistency over the info
        block (numpy, for the CPU golden path)."""
        from .codes.crc import crc_matrix

        k_info = self.code.k_info
        k_msg = k_info - self._crc_len
        info = bits[:, np.asarray(self.code.info_positions)].astype(np.int64)
        par = (info[:, :k_msg] @ crc_matrix(k_msg, self.crc).astype(np.int64)) & 1
        return (par == info[:, k_msg:k_info]).all(axis=1)
