"""fastecc_tpu_torch: the PyTorch/CUDA port of fastecc_tpu.

The codec's encode, erasure-decode and error-correction paths on one
NVIDIA H100: Reed-Solomon over GF(0xFFF00001) and GF(0x10001) via NTTs
whose passes are CUDA kernels written for Hopper (``csrc/``), bit for bit
equal to the JAX package.
The port imports neither JAX nor the JAX package.

Public API (module names mirror ``fastecc_tpu``):
  fields.GF32 / fields.GF16        — the two prime fields
  ntt.ntt_auto                     — NTT along axis 0 (kernels on CUDA)
  rs.encode_parity / rs.encode     — field-domain RS encode
  rs.encode_blocks(_parts)         — raw bytes in, wire parity out (GF32)
  rs.encode_blocks_gf16_parts /
    rs.wire_gf16_from_parts        — the GF16 wire pair (K8 -> K9 -> K10)
  rs.update_parity(_multi), rs.verify_codeword, rs.encode_parity_batch,
    rs.encode_parity_stream        — partial writes, scrub, batches, streams
  decode.prepare_decode_tables /
    decode.decode_prepared         — erasure decode (K5 -> K6 -> K7-sel)
  decode.decode_stream             — out-of-core decode over lane chunks
  decode.decode_blocks             — surviving wire blocks in, data out
  decode.decode_wire_parts         — all-data-erased wire decode
  decode.locate_errors /
    decode.correct_errors          — unknown-position error correction
                                     (decode_blocks(check=True))
  testing                          — erasure-pattern generators
  packing                          — the wire format
  interop                          — numpy <-> tensor, device policy
  kernels.ntt_mfa                  — the pass wrappers and their launches,
                                     the opt-in one-pass lanes pair
                                     (FASTECC_LANES_PAIR: K11, K12)
  kernels.microbench               — the card's peaks (copy, chains, fused
                                     chains: K13-K15), measure_peaks
  utils.profiling                  — the roofline model, torch.profiler;
                                     trace(log_dir) records the card's
                                     kernels with the port's spans
                                     (fecc.rs.*, fecc.decode.*,
                                     fecc.pass.<key>, fecc.rs.wire_join)
  parallel                         — the sharded codec on torch.distributed:
                                     make_mesh, ntt_sharded(_overlap),
                                     encode_parity_sharded, decode_sharded
                                     (one process a rank, local shards)
  cli                              — the reference's commands, scaling too

Entry points run on the card unless the caller passes CPU tensors or
``device="cpu"``; without a GPU they raise rather than fall back.
"""

from fastecc_tpu_torch.fields import FIELDS, GF16, GF32, FieldSpec

__all__ = ["FIELDS", "GF16", "GF32", "FieldSpec"]

__version__ = "0.1.0"
