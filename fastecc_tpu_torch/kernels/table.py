"""The table multiply (``csrc/table.cu``): y * t mod p, u32 in and out, over
y's last axis as lanes and its other axes as rows, ``t`` a contiguous u32
table on y's device of one prepared word (``ntt.prepare_consts``) a row or
one word for all. :func:`mul_table` launches the kernel once on a CUDA
tensor (counted in :data:`LAUNCHES`), the plain version on a CPU tensor,
and opens no span: a trace gives the launch to the caller's span."""

from __future__ import annotations

import torch

from ..fields import FieldSpec
from ..ntt import mul_prepared
from . import _build

# Launches of ``csrc/table.cu`` (``ntt_mfa.LAUNCHES`` counts the passes').
LAUNCHES = {"mul_table": 0}

# Elements per row chunk of the plain version (~10 int64 carriers each).
_MUL_CHUNK = 1 << 24


def reset_launches() -> None:
    LAUNCHES["mul_table"] = 0


def _on_card(y: torch.Tensor) -> bool:
    """Launch the kernel (CUDA) or take the plain version (CPU)?"""
    if y.device.type not in ("cpu", "cuda"):
        raise ValueError(f"mul_table: unsupported device {y.device}")
    return y.device.type == "cuda"


def _check_table(y: torch.Tensor, t: torch.Tensor) -> int:
    """The rows of ``y`` (its leading axes flattened) once ``t`` is a
    contiguous u32 table on y's device of a word a row, or of one word."""
    lanes = y.shape[-1]
    rows = y.numel() // lanes if lanes else 0
    if (t.dtype != torch.uint32 or t.device != y.device
            or not t.is_contiguous() or t.dim() != 1
            or t.numel() not in (1, rows)):
        raise ValueError(f"the table multiply takes a contiguous u32 table "
                         f"of 1 or {rows} words on {y.device}, got "
                         f"{t.dtype} {tuple(t.shape)} on {t.device}")
    return rows


def _by_rows(y: torch.Tensor, fn) -> torch.Tensor:
    """``fn(y[i0:i1], i0, i1)`` (u32 in, u32 out) over row chunks of at
    most :data:`_MUL_CHUNK` elements, into one u32 tensor like ``y``."""
    out = torch.empty_like(y.view(torch.int32))
    step = max(1, _MUL_CHUNK // max(1, y[0].numel()))
    for i0 in range(0, y.shape[0], step):
        i1 = min(i0 + step, y.shape[0])
        out[i0:i1].copy_(fn(y[i0:i1], i0, i1).view(torch.int32))
    return out.view(torch.uint32)


def mul_table_plain(field: FieldSpec, y: torch.Tensor, t: torch.Tensor
                    ) -> torch.Tensor:
    """The plain version: ``ntt.mul_prepared`` over row chunks."""
    tt = t.expand(_check_table(y, t))[:, None]
    y2 = y.view(torch.int32).reshape(-1, y.shape[-1]).view(torch.uint32)
    out = _by_rows(y2, lambda v, i0, i1: mul_prepared(field, v, tt[i0:i1]))
    return out.view(torch.int32).reshape(y.shape).view(torch.uint32)


def mul_table(field: FieldSpec, y: torch.Tensor, t: torch.Tensor
              ) -> torch.Tensor:
    """y * t mod p (a copy first where y is not contiguous on a card)."""
    if not _on_card(y):
        return mul_table_plain(field, y, t)
    y = y.view(torch.int32).contiguous().view(torch.uint32)
    rows = _check_table(y, t)
    out = torch.empty_like(y.view(torch.int32)).view(torch.uint32)
    with torch.cuda.device(y.device):
        _build.call("fecc_mul_table", 0 if field.use_mont else 1,
                    y.data_ptr(), out.data_ptr(), rows, y.shape[-1],
                    t.data_ptr(), int(t.numel() == rows),
                    torch.cuda.current_stream(y.device).cuda_stream)
    LAUNCHES["mul_table"] += 1
    return out
