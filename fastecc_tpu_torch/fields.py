"""Field specifications for the PyTorch/CUDA port of the codec.

A copy of ``fastecc_tpu/fields.py`` (the port imports nothing of the JAX
package): the two supported prime fields, their primitive roots, maximal
power-of-two NTT orders and the Montgomery constants. These constants
define bit-exactness for both packages.

Fields:
  * GF32: p = 0xFFF00001 = 2^32 - 2^20 + 1 (prime), max NTT order 2^20.
  * GF16: p = 0x10001 = 65537 (Fermat prime F4), max NTT order 2^16.
"""

from __future__ import annotations

import dataclasses
import functools


@dataclasses.dataclass(frozen=True)
class FieldSpec:
    """A prime field GF(p) with power-of-two NTT support.

    Frozen and hashable, so it can key the host table caches; every
    derived quantity is a Python int computed on the host.

    Attributes:
      name: human-readable identifier.
      p: the prime modulus.
      bits: nominal word width of raw data for this field (32 or 16).
      g: smallest primitive root of p.
      max_log2: v2(p - 1); maximal supported transform order is 2**max_log2.
      use_mont: whether multiplication uses Montgomery REDC with R = 2^32
        (GF32, whose products exceed 32 bits; GF16 products fit in 32 bits
        and use the Fermat-prime reduction 2^16 = -1 mod p).
      r_mod_p: R mod p (the Montgomery form of 1), only for use_mont fields.
      r2_mod_p: R^2 mod p (used to enter the Montgomery domain).
      n_prime: -p^-1 mod 2^32 (the REDC constant).
    """

    name: str
    p: int
    bits: int
    g: int
    max_log2: int
    use_mont: bool
    r_mod_p: int = 0
    r2_mod_p: int = 0
    n_prime: int = 0

    def __post_init__(self):
        assert (self.p - 1) % (1 << self.max_log2) == 0
        if self.use_mont:
            assert (self.r_mod_p - (1 << 32)) % self.p == 0
            assert (self.r2_mod_p - (1 << 64)) % self.p == 0
            assert (self.n_prime * self.p) % (1 << 32) == (1 << 32) - 1

    # ---- host-side (Python int) field arithmetic: table construction and
    # the oracle in tests.

    def pow_host(self, a: int, e: int) -> int:
        return pow(a % self.p, e, self.p)

    def inv_host(self, a: int) -> int:
        return pow(a % self.p, self.p - 2, self.p)

    @functools.lru_cache(maxsize=None)
    def root_of_order(self, order: int) -> int:
        """Primitive root of unity of the given power-of-two order."""
        assert order & (order - 1) == 0, "order must be a power of two"
        assert order <= (1 << self.max_log2), (
            f"{self.name}: max NTT order is 2^{self.max_log2}, got {order}")
        w = pow(self.g, (self.p - 1) // order, self.p)
        if order > 1:
            assert pow(w, order // 2, self.p) == self.p - 1
        return w

    def to_mont_host(self, a: int) -> int:
        """Map a into the Montgomery domain (a * R mod p) on the host."""
        if not self.use_mont:
            return a % self.p
        return (a << 32) % self.p


# GF(p), p = 0xFFF00001 = 4293918721 = 2^32 - 2^20 + 1.
# p - 1 = 2^20 * 3^2 * 5 * 7 * 13; smallest primitive root g = 19.
# omega_{2^20} = 19^((p-1)/2^20) = 0xBC26110E. Montgomery R = 2^32.
GF32 = FieldSpec(
    name="GF32",
    p=0xFFF00001,
    bits=32,
    g=19,
    max_log2=20,
    use_mont=True,
    r_mod_p=0x000FFFFF,
    r2_mod_p=0x0FDFFF01,
    n_prime=0xFFEFFFFF,
)

# GF(p), p = 0x10001 = 65537 (Fermat prime F4). p - 1 = 2^16; g = 3 is a
# primitive root and is itself the root of order 2^16.
GF16 = FieldSpec(
    name="GF16",
    p=0x10001,
    bits=16,
    g=3,
    max_log2=16,
    use_mont=False,
)

FIELDS = {"GF32": GF32, "GF16": GF16}

# Import-time sanity checks of the headline roots.
assert GF32.root_of_order(1 << 20) == 0xBC26110E
assert GF32.inv_host(1 << 20) == 4293914626
assert GF16.root_of_order(1 << 16) == 3
