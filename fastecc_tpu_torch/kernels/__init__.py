"""Hopper kernels of the port and their wrappers (``ntt_mfa``: the passes;
``microbench``: the peaks; ``table``: the sharded codec's table multiply;
``pack``: the GF32 escape pack);
the CUDA sources live in ``fastecc_tpu_torch/csrc/`` and build on first use
(``_build``); ``sass`` reads what the compiler made of them."""

from .ntt_mfa import LAUNCHES, reset_launches  # noqa: F401
