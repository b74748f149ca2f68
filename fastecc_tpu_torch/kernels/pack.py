"""The GF32 escape pack (``csrc/pack.cu``): u32 words in, u32 [stored lanes
| escape bitmap lanes] out, over the words' last axis as a block's words
and the other axes as rows (``packing``'s wire format: a word w >= p is
stored as w - p with its escape bit set; bit j of bitmap lane m is word
16m + j's). :func:`pack_gf32` launches the kernel once on a CUDA tensor
(counted in :data:`LAUNCHES`), the plain version on a CPU tensor, and
opens no span: a trace gives the launch to the caller's span
(``fecc.packing.pack_data``)."""

from __future__ import annotations

import torch

from .. import gf
from ..fields import GF32
from . import _build

# Launches of ``csrc/pack.cu``.
LAUNCHES = {"pack_gf32": 0}


def reset_launches() -> None:
    LAUNCHES["pack_gf32"] = 0


def _pack_bits(bits: torch.Tensor, group: int) -> torch.Tensor:
    """[..., L] 0/1 carriers -> [..., ceil(L/group)] carriers (bit j of
    word m is element m*group + j; trailing bits zero). The shift-or
    form; the reference's MXU form on the TPU gives the same bits."""
    length = bits.shape[-1]
    pad = (-length) % group
    if pad:
        bits = torch.nn.functional.pad(bits, (0, pad))
    n_words = bits.shape[-1] // group
    b = bits.reshape(bits.shape[:-1] + (n_words, group))
    shifts = torch.arange(group, dtype=torch.int64, device=bits.device)
    return (b << shifts).sum(dim=-1)


def _on_card(words: torch.Tensor) -> bool:
    """Launch the kernel (CUDA) or take the plain version (CPU)? Raises on
    another device, a dtype other than u32 or a rank below 2."""
    if words.device.type not in ("cpu", "cuda"):
        raise ValueError(f"pack_gf32: unsupported device {words.device}")
    if words.dtype != torch.uint32 or words.dim() < 2:
        raise ValueError(f"pack_gf32 takes u32 words of rank 2 or more, "
                         f"got {words.dtype} {tuple(words.shape)}")
    return words.device.type == "cuda"


def pack_gf32_plain(words: torch.Tensor) -> torch.Tensor:
    """The plain version: int64 torch ops."""
    w = gf.widen(words)
    esc = (w >= GF32.p).to(torch.int64)
    stored = w - esc * GF32.p
    return gf.narrow(torch.cat([stored, _pack_bits(esc, 16)], dim=-1))


def pack_gf32(words: torch.Tensor) -> torch.Tensor:
    """[..., W] u32 -> [..., W + ceil(W/16)] u32 (a copy first where the
    words are not contiguous on a card)."""
    if not _on_card(words):
        return pack_gf32_plain(words)
    words = words.view(torch.int32).contiguous().view(torch.uint32)
    n = words.shape[-1]
    rows = words.numel() // n if n else 0
    out = torch.empty(words.shape[:-1] + (n + -(-n // 16),),
                      dtype=torch.int32, device=words.device)
    with torch.cuda.device(words.device):
        _build.call("fecc_pack_gf32", words.data_ptr(), out.data_ptr(), rows,
                    n, torch.cuda.current_stream(words.device).cuda_stream)
    LAUNCHES["pack_gf32"] += 1
    return out.view(torch.uint32)
