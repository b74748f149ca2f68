"""Hopper kernels of the port and their wrappers (``ntt_mfa``); the CUDA
sources live in ``fastecc_tpu_torch/csrc/`` and build on first use
(``_build``)."""

from .ntt_mfa import LAUNCHES, reset_launches  # noqa: F401
