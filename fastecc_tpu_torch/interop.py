"""Moving state between the JAX package and the port, and onto a device.

The codec has no model weights: its state is u32 field arrays and raw
byte blocks. The JAX package hands them over as numpy arrays
(``np.asarray(jax_array)``); :func:`from_numpy_u32` makes the port's
tensor of the same layout and :func:`to_numpy_u32` goes back, so a test
compares the two packages' outputs with ``assert_array_equal``.

Device policy for every entry point: a tensor keeps its device; a numpy
array goes to ``device`` (default ``"cuda"``). With no GPU and no explicit
CPU request this raises — the port never carries on quietly on the CPU.
"""

from __future__ import annotations

import numpy as np
import torch

from .fields import FIELDS, FieldSpec


def resolve_device(device=None) -> torch.device:
    """The device for host data: ``device`` if given, else the card.
    Raises if that is a CUDA device and no GPU is present."""
    dev = torch.device("cuda" if device is None else device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            "no CUDA device is available; pass device='cpu' to run the "
            "plain PyTorch path on the CPU")
    return dev


def as_tensor(x, device=None) -> torch.Tensor:
    """``x`` as a tensor: a tensor keeps its device (or moves to an
    explicit ``device``), a numpy array goes to :func:`resolve_device`.
    u32 arrays become ``torch.uint32``; other dtypes keep theirs."""
    if isinstance(x, torch.Tensor):
        return x if device is None else x.to(torch.device(device))
    arr = np.ascontiguousarray(x)
    dev = resolve_device(device)
    if arr.dtype == np.uint32:
        return torch.from_numpy(arr.view(np.int32)).view(torch.uint32).to(dev)
    return torch.from_numpy(arr).to(dev)


def from_numpy_u32(arr, device=None) -> torch.Tensor:
    """numpy u32 array (e.g. a JAX package output) -> ``torch.uint32``
    tensor of the same shape on ``device`` (default: the card)."""
    arr = np.asarray(arr)
    if arr.dtype != np.uint32:
        raise TypeError(f"expected a uint32 array, got {arr.dtype}")
    return as_tensor(arr, device)


def to_numpy_u32(t: torch.Tensor) -> np.ndarray:
    """``torch.uint32`` tensor -> numpy u32 array (host copy)."""
    if t.dtype != torch.uint32:
        raise TypeError(f"expected a torch.uint32 tensor, got {t.dtype}")
    return t.detach().contiguous().view(torch.int32).cpu().numpy().view(
        np.uint32)


def field_by_name(name: str) -> FieldSpec:
    """Resolve ``"GF32"`` / ``"GF16"`` to the port's FieldSpec."""
    try:
        return FIELDS[name]
    except KeyError:
        raise ValueError(
            f"unknown field {name!r}; known: {sorted(FIELDS)}") from None
