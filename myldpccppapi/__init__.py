"""myldpccppapi: a quasi-cyclic LDPC channel-coding framework in JAX.

Built from scratch in JAX (plus one CUDA decode kernel) with the capabilities of the C++/OpenCL
reference wing02/MyLdpcCppApi (see SURVEY.md): QC parity-check construction,
systematic Richardson-Urbanke GF(2) encoding, BPSK/AWGN channel simulation,
and batched belief-propagation decoding (flooding/layered, min-sum /
normalized / offset / sum-product) with per-codeword syndrome early
termination — scaled over device meshes via shard_map with psum'd statistics.
"""
from .codes import Encoder, QCCode, regular, wimax, wifi
from .decoder import DecodeResult, Decoder
from .utils.config import DecoderConfig, RunConfig
from .coder import Coder, make_codec

__version__ = "0.1.0"

__all__ = [
    "Coder",
    "make_codec",
    "Decoder",
    "DecodeResult",
    "DecoderConfig",
    "Encoder",
    "QCCode",
    "RunConfig",
    "regular",
    "wimax",
    "wifi",
    "__version__",
]
