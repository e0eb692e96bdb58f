"""Compute ops: channel simulation, modulation, bit packing, BP decoders
(jnp/XLA paths; the fused CUDA kernel's host side is ops/cuda_bp.py)."""
from . import (bitflip, bp, bp_edgelist, channel, golden, impulse,
               modulation, packing)

__all__ = ["bitflip", "bp", "bp_edgelist", "channel", "golden", "impulse",
           "modulation", "packing"]
