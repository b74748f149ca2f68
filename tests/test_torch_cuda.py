"""The port's CUDA kernels on the card: each of K1-K4 against its plain
version, and the entry points on the card against the same calls on the
CPU. Every test here needs a CUDA device and skips without one.

The file imports neither JAX nor the JAX package, so it also runs on a
machine with the card and no JAX; there the JAX-pinning conftest is left
out:

    python -m pytest --noconftest -p no:cacheprovider -m cuda tests/test_torch_cuda.py
"""

import numpy as np
import pytest
import torch

from fastecc_tpu_torch import fields, ntt, rs
from fastecc_tpu_torch.interop import from_numpy_u32
from fastecc_tpu_torch.kernels import ntt_mfa as m

torch.set_num_threads(1)

RNG = np.random.default_rng(0xC0DB)
FIELDS = [fields.GF32, fields.GF16]

pytestmark = pytest.mark.cuda


def rand_field(field, shape):
    return RNG.integers(0, field.p, size=shape, dtype=np.uint64).astype(
        np.uint32)


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (the kernels have no CPU mode)")
    return torch.device("cuda")


@pytest.mark.parametrize("field", FIELDS, ids=lambda f: f.name)
def test_kernels_match_plain_on_card(field, cuda_device):
    """K1-K4 vs their plain versions on the card, small orders, ragged
    lane counts."""
    for k, lanes in ((4, 3), (1 << 7, 13), (1 << 10, 40)):
        g = field.root_of_order(2 * k)
        c1 = m._pair_split(k)
        x = from_numpy_u32(rand_field(field, (c1, k // c1, lanes)),
                           cuda_device)
        y = from_numpy_u32(rand_field(field, (k // c1, c1, lanes)),
                           cuda_device)
        assert torch.equal(m.col_pass(x, field, inverse=True),
                           m.col_pass_plain(x, field, inverse=True))
        assert torch.equal(m.col_pass_pre(x, field, g),
                           m.col_pass_plain(x, field, pre_seed=g))
        assert torch.equal(m.seam_pass(y, field, g),
                           m.seam_pass_plain(y, field, g))
        assert torch.equal(m.row_pass(x, field), m.row_pass_plain(x, field))


@pytest.mark.parametrize("field", FIELDS, ids=lambda f: f.name)
@pytest.mark.parametrize("k,n", [(8, 16), (64, 256), (256, 512)])
def test_entry_points_on_card_match_cpu(field, k, n, cuda_device):
    """encode_parity and ntt_auto on the card (kernels) == on the CPU
    (plain versions), and the launches are counted."""
    data = rand_field(field, (k, 5))
    m.reset_launches()
    got = rs.encode_parity(data, field, n)
    assert got.is_cuda
    assert torch.equal(got.cpu(), rs.encode_parity(data, field, n,
                                                   device="cpu"))
    assert m.LAUNCHES["K1_col"] > 0 and m.LAUNCHES["K3_row"] > 0
    assert m.LAUNCHES["K2_seam" if n == 2 * k else "K4_col_pre"] > 0
    for kw in ({}, {"inverse": True}, {"pre_seed": 7}):
        assert torch.equal(ntt.ntt_auto(data, field, **kw).cpu(),
                           ntt.ntt_auto(data, field, device="cpu", **kw))


def test_card_refuses_what_it_does_not_run(cuda_device):
    x = from_numpy_u32(rand_field(fields.GF32, (2, 4)), cuda_device)
    with pytest.raises(ValueError, match="order >= 4"):
        ntt.ntt_auto(x, fields.GF32)
    raw = torch.zeros((4, 64), dtype=torch.uint8, device=cuda_device)
    with pytest.raises(NotImplementedError, match="K8-K10"):
        rs.encode_blocks(raw, fields.GF16)
