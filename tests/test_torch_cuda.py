"""The port's CUDA kernels on the card: each of K1-K7 against its plain
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

from fastecc_tpu_torch import decode, fields, ntt, rs, testing
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
def test_decode_kernels_match_plain_on_card(field, cuda_device):
    """K5, K6, K7 and K7-sel vs their plain versions on the card, small
    orders, ragged lane counts; GF16 tables hold 0x10000."""
    for k, lanes in ((4, 3), (1 << 7, 13), (1 << 10, 40)):
        c1 = m._pair_split(k)
        x = from_numpy_u32(rand_field(field, (c1, k // c1, lanes)),
                           cuda_device)
        y = from_numpy_u32(rand_field(field, (k // c1, c1, lanes)),
                           cuda_device)
        vals = rand_field(field, k)
        if not field.use_mont:
            vals[::3] = 0x10000
        v = from_numpy_u32(vals, cuda_device)
        mask = from_numpy_u32((RNG.random(k) < 0.5).astype(np.uint32),
                              cuda_device)
        for inv in (False, True):
            assert torch.equal(m.col_pass_vec(x, field, v, inverse=inv),
                               m.col_pass_plain(x, field, inverse=inv,
                                                pre_vec=v))
        assert torch.equal(m.seam_pass_vec(y, field, v),
                           m.seam_pass_plain(y, field, pre_vec2=v))
        assert torch.equal(m.row_pass_post(x, field, v),
                           m.row_pass_plain(x, field, post_vec=v))
        assert torch.equal(m.row_pass_post(x, field, v, mask, y.reshape(
            x.shape)), m.row_pass_plain(x, field, post_vec=v, sel_mask=mask,
                                        sel_orig=y.reshape(x.shape)))


@pytest.mark.parametrize("field", FIELDS, ids=lambda f: f.name)
def test_decode_on_card_matches_cpu(field, cuda_device):
    """decode_prepared (merge on and off), decode and the device tables
    on the card == on the CPU; the decode pair launches K5, K6, K7-sel."""
    n, k, lanes = 1 << 9, 1 << 8, 7
    erased = testing.random_erasures(n, n - k, seed=2)
    cw = rs.encode(rand_field(field, (k, lanes)), field, n, device="cpu")
    tabs_cpu = decode.prepare_decode_tables(erased, n, field, "device",
                                            device="cpu")
    tabs = decode.prepare_decode_tables(erased, n, field, "device")
    for a, b in zip(tabs, tabs_cpu):
        assert torch.equal(a.cpu(), b)
    for merge in (True, False):
        m.reset_launches()
        got = decode.decode_prepared(cw.to(cuda_device), *tabs, field,
                                     merge=merge)
        assert m.LAUNCHES["K5_col_vec"] == 1 and m.LAUNCHES["K6_seam_vec"] == 1
        assert m.LAUNCHES["K7_row_post_sel" if merge else "K7_row_post"] == 1
        assert torch.equal(got.cpu(), decode.decode_prepared(
            cw, *tabs_cpu, field, merge=merge))
    assert torch.equal(decode.decode(cw.to(cuda_device), erased, field).cpu(),
                       cw)


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
    v = rand_field(field, k)
    for kw in ({}, {"inverse": True}, {"pre_seed": 7}, {"pre_vec": v},
               {"post_vec": v, "sel_mask": v % 2, "sel_orig": data}):
        assert torch.equal(ntt.ntt_auto(data, field, **kw).cpu(),
                           ntt.ntt_auto(data, field, device="cpu", **kw))


def test_card_refuses_what_it_does_not_run(cuda_device):
    x = from_numpy_u32(rand_field(fields.GF32, (2, 4)), cuda_device)
    with pytest.raises(ValueError, match="order >= 4"):
        ntt.ntt_auto(x, fields.GF32)
    raw = torch.zeros((4, 64), dtype=torch.uint8, device=cuda_device)
    with pytest.raises(NotImplementedError, match="K8-K10"):
        rs.encode_blocks(raw, fields.GF16)
