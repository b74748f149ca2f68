"""fastecc_tpu_torch: the PyTorch/CUDA port of fastecc_tpu.

The codec's encode path on one NVIDIA H100: Reed-Solomon encode over
GF(0xFFF00001) and GF(0x10001) via NTTs whose passes are CUDA kernels
written for Hopper (``csrc/``), bit for bit equal to the JAX package.
The port imports neither JAX nor the JAX package.

Public API (module names mirror ``fastecc_tpu``):
  fields.GF32 / fields.GF16        — the two prime fields
  ntt.ntt_auto                     — NTT along axis 0 (kernels on CUDA)
  rs.encode_parity / rs.encode     — field-domain RS encode
  rs.encode_blocks(_parts)         — raw bytes in, wire parity out (GF32)
  packing                          — the wire format
  interop                          — numpy <-> tensor, device policy
  kernels.ntt_mfa                  — the pass wrappers and their launches

Entry points run on the card unless the caller passes CPU tensors or
``device="cpu"``; without a GPU they raise rather than fall back.
"""

from fastecc_tpu_torch.fields import FIELDS, GF16, GF32, FieldSpec

__all__ = ["FIELDS", "GF16", "GF32", "FieldSpec"]

__version__ = "0.1.0"
