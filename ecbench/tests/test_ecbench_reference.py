"""The plain reference against the repository's golden pins, its own
decode against its encode, and the control against the exact arithmetic.
CPU only."""

import hashlib

import numpy as np
import pytest
import torch

from ecbench.reference import rs as ref

# SHA-256 of the k = 64, 4-lane codewords (tests/test_rs.py GOLDEN)
GOLDEN_CODEWORD = {
    "GF32": "edf67c1247ff14ab94dd84ec24f200b7b40c9b65814b764ab29e7bc4494101e2",
    "GF16": "6a407726e3d6a7ee6501f145b3dcf4be91ecb2871357991b466357ee0f472fae",
}
# tests/test_wire_golden.py: GF16 encode_blocks parity blob, and the GF16
# parity serialization with escapes at a bitmap group's edges
GOLDEN_BLOB_GF16 = ("bcc7aac37e2f7a4be2e6007fe7e881f0"
                    "e0b4a42e8c2751f80862281d211d7b0e")
GOLDEN_ESCAPES_GF16 = ("ac60b01d7b6b5612272368c4e3eb3b8b"
                       "b5cf3f5106420c22784722e8253795ca")


def _sha(a) -> str:
    return hashlib.sha256(np.ascontiguousarray(a).tobytes()).hexdigest()


def _golden_data(p: int) -> torch.Tensor:
    i = np.arange(64, dtype=np.uint64)[:, None]
    lane = np.arange(4, dtype=np.uint64)[None, :]
    return torch.from_numpy(((i * 1000003 + lane * 7919 + 1) % p).astype(
        np.int64))


@pytest.mark.parametrize("name", ["GF32", "GF16"])
def test_codeword_matches_golden(name):
    f = ref.Field(name)
    cw = f.codeword(_golden_data(f.p), 128).numpy().astype(np.uint32)
    assert _sha(cw) == GOLDEN_CODEWORD[name]


def test_gf16_wire_blob_matches_golden():
    rng = np.random.default_rng(0xC13)
    rng.integers(0, 1 << 32, size=(4, 1024), dtype=np.uint64)      # skip
    raw = rng.integers(0, 256, size=(4, 4096),
                       dtype=np.uint16).astype(np.uint8)
    parity = ref.Field("GF16").encode_parity(
        ref.gf16_words(torch.from_numpy(raw)), 8)
    blob = ref.gf16_wire(parity).numpy()
    assert blob.shape == (4, 4352)
    assert _sha(blob) == GOLDEN_BLOB_GF16


def test_gf16_wire_escapes_match_golden():
    rng = np.random.default_rng(0xC13)
    rng.integers(0, 1 << 32, size=(4, 1024), dtype=np.uint64)      # skip
    rng.integers(0, 256, size=(4, 4096), dtype=np.uint16)          # skip
    rng.integers(0, 0xFFF00001, size=(3, 1088), dtype=np.uint64)   # skip
    pf = rng.integers(0, 0x10000, size=(3, 2048), dtype=np.uint64)
    pf[0, [0, 15, 16, 2047]] = 0x10000
    pf[2, 100] = 0x10000
    ser = ref.gf16_wire(torch.from_numpy(pf.astype(np.int64))).numpy()
    assert ser.shape == (3, 4352)
    assert _sha(ser) == GOLDEN_ESCAPES_GF16


@pytest.mark.parametrize("name", ["GF32", "GF16"])
@pytest.mark.parametrize("n,k,lost", [(128, 64, 64), (128, 64, 37),
                                      (256, 64, 192), (64, 32, 1)])
def test_decode_recovers_encode(name, n, k, lost):
    f = ref.Field(name)
    g = torch.Generator().manual_seed(n + k + lost)
    data = torch.randint(0, f.p, (k, 3), generator=g)
    cw = f.codeword(data, n)
    erased = torch.randperm(n, generator=g)[:lost]
    garbled = cw.clone()
    garbled[erased] = torch.randint(0, f.p, (lost, 3), generator=g)
    assert torch.equal(f.decode(garbled, erased), cw)


@pytest.mark.parametrize("name", ["GF32", "GF16"])
def test_ntt_matches_the_plain_sum(name):
    f = ref.Field(name)
    n = 16
    x = torch.randint(0, f.p, (n, 2), generator=torch.Generator().manual_seed(1))
    w = f.root(n)
    want = [[sum(int(x[i, c]) * pow(w, i * j, f.p) for i in range(n)) % f.p
             for c in range(2)] for j in range(n)]
    assert f.ntt(x, w).tolist() == want
    assert torch.equal(f.intt(f.ntt(x, w), w), x)


@pytest.mark.parametrize("name", ["GF32", "GF16"])
def test_control_rounds_products(name):
    data = _golden_data(ref.PRIMES[name][0])
    exact = ref.Field(name).encode_parity(data, 128)
    control = ref.Field(name, control=True).encode_parity(data, 128)
    assert (control != exact).float().mean() > 0.9
