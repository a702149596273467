"""Finite-field GF(q) arithmetic for prime and prime-power q.

The PolarFly construction (paper §IV) needs dot products, cross products and
left-normalization of length-3 vectors over F_q, for *any* prime power
q = p^m.  Elements are represented as integers in [0, q): for m == 1 the
integer itself; for m > 1 the base-p digit packing of the polynomial
coefficients (little-endian: value = sum_i c_i * p**i).

All operations are exposed as vectorized numpy table lookups so that graph
construction is O(N^2) array code.  (For prime q the all-pairs cross
product also runs on the card: `repro_torch.kernels.gf_crossprod`.)
"""

from __future__ import annotations

import functools
from dataclasses import dataclass, field

import numpy as np

__all__ = [
    "is_prime",
    "prime_power_decompose",
    "is_prime_power",
    "GF",
    "primes_and_prime_powers",
]


def is_prime(n: int) -> bool:
    if n < 2:
        return False
    if n < 4:
        return True
    if n % 2 == 0:
        return False
    i = 3
    while i * i <= n:
        if n % i == 0:
            return False
        i += 2
    return True


def prime_power_decompose(n: int):
    """Return (p, m) with n == p**m and p prime, else None."""
    if n < 2:
        return None
    for p in range(2, int(n ** 0.5) + 1):
        if n % p == 0:
            if not is_prime(p):
                return None
            m = 0
            x = n
            while x % p == 0:
                x //= p
                m += 1
            return (p, m) if x == 1 else None
    return (n, 1)  # n itself is prime


def is_prime_power(n: int) -> bool:
    return prime_power_decompose(n) is not None


def primes_and_prime_powers(lo: int, hi: int):
    """All prime powers q with lo <= q <= hi (inclusive)."""
    return [q for q in range(max(lo, 2), hi + 1) if is_prime_power(q)]


# ----------------------------------------------------------------------------
# Polynomial helpers over F_p (coefficients little-endian lists of ints)
# ----------------------------------------------------------------------------

def _poly_mulmod(a, b, mod_poly, p):
    """(a * b) mod mod_poly over F_p. mod_poly is monic of degree m."""
    m = len(mod_poly) - 1
    res = [0] * (len(a) + len(b) - 1)
    for i, ai in enumerate(a):
        if ai == 0:
            continue
        for j, bj in enumerate(b):
            res[i + j] = (res[i + j] + ai * bj) % p
    # reduce
    for d in range(len(res) - 1, m - 1, -1):
        c = res[d]
        if c == 0:
            continue
        # res -= c * x^(d-m) * mod_poly
        for k in range(m + 1):
            res[d - m + k] = (res[d - m + k] - c * mod_poly[k]) % p
    return [c % p for c in res[:m]] + [0] * max(0, m - len(res))


def _int_to_poly(v: int, p: int, m: int):
    out = []
    for _ in range(m):
        out.append(v % p)
        v //= p
    return out


def _poly_to_int(c, p: int) -> int:
    v = 0
    for d in reversed(c):
        v = v * p + d
    return v


def _find_irreducible(p: int, m: int):
    """Smallest monic irreducible polynomial of degree m over F_p.

    Brute force: a monic degree-m poly is irreducible iff it has no monic
    factor of degree 1..m//2.  m <= 7 in practice, fine.
    """
    monics = {d: [] for d in range(1, m)}
    for d in range(1, m):
        for v in range(p ** d):
            monics[d].append(_int_to_poly(v, p, d) + [1])

    def divides(f, g):
        # polynomial long division g / f over F_p, return True if remainder 0
        g = list(g)
        df, dg = len(f) - 1, len(g) - 1
        inv_lead = pow(f[-1], p - 2, p) if p > 2 else f[-1]
        while dg >= df:
            c = (g[dg] * inv_lead) % p
            if c:
                for k in range(df + 1):
                    g[dg - df + k] = (g[dg - df + k] - c * f[k]) % p
            dg -= 1
            while dg >= 0 and g[dg] == 0:
                dg -= 1
        return dg < 0

    for v in range(p ** m):
        cand = _int_to_poly(v, p, m) + [1]  # monic
        if cand[0] == 0:  # divisible by x
            continue
        ok = True
        for d in range(1, m // 2 + 1):
            for f in monics[d]:
                if divides(f, cand):
                    ok = False
                    break
            if not ok:
                break
        if ok:
            return cand
    raise ValueError(f"no irreducible polynomial found for p={p} m={m}")


# ----------------------------------------------------------------------------
# GF(q) with dense lookup tables
# ----------------------------------------------------------------------------

@dataclass
class GF:
    """Finite field GF(q), q = p^m, with dense add/mul/inv tables."""

    q: int
    p: int = field(init=False)
    m: int = field(init=False)
    add_table: np.ndarray = field(init=False, repr=False)
    mul_table: np.ndarray = field(init=False, repr=False)
    neg_table: np.ndarray = field(init=False, repr=False)
    inv_table: np.ndarray = field(init=False, repr=False)

    def __post_init__(self):
        dec = prime_power_decompose(self.q)
        if dec is None:
            raise ValueError(f"q={self.q} is not a prime power")
        self.p, self.m = dec
        q, p, m = self.q, self.p, self.m
        dt = np.int32
        if m == 1:
            a = np.arange(q, dtype=np.int64)
            self.add_table = ((a[:, None] + a[None, :]) % q).astype(dt)
            self.mul_table = ((a[:, None] * a[None, :]) % q).astype(dt)
            self.neg_table = ((-a) % q).astype(dt)
        else:
            mod_poly = _find_irreducible(p, m)
            polys = [_int_to_poly(v, p, m) for v in range(q)]
            # addition: digit-wise mod p
            digits = np.array(polys, dtype=np.int64)  # [q, m]
            summed = (digits[:, None, :] + digits[None, :, :]) % p
            weights = p ** np.arange(m, dtype=np.int64)
            self.add_table = (summed @ weights).astype(dt)
            self.neg_table = (((-digits) % p) @ weights).astype(dt)
            mul = np.zeros((q, q), dtype=dt)
            for i in range(q):
                for j in range(i, q):
                    v = _poly_to_int(_poly_mulmod(polys[i], polys[j], mod_poly, p), p)
                    mul[i, j] = v
                    mul[j, i] = v
            self.mul_table = mul
        inv = np.zeros(q, dtype=dt)
        for x in range(1, q):
            ys = np.where(self.mul_table[x] == 1)[0]
            assert len(ys) == 1, f"non-field multiplication table at x={x}"
            inv[x] = ys[0]
        self.inv_table = inv

    # -- scalar/array ops (all accept numpy int arrays, broadcast) -----------
    def add(self, a, b):
        return self.add_table[a, b]

    def sub(self, a, b):
        return self.add_table[a, self.neg_table[b]]

    def mul(self, a, b):
        return self.mul_table[a, b]

    def neg(self, a):
        return self.neg_table[a]

    def inv(self, a):
        return self.inv_table[a]

    # -- length-3 vector ops --------------------------------------------------
    def dot3(self, u, v):
        """Dot product of [..., 3] int arrays over GF(q)."""
        u = np.asarray(u)
        v = np.asarray(v)
        s = self.mul(u[..., 0], v[..., 0])
        s = self.add(s, self.mul(u[..., 1], v[..., 1]))
        s = self.add(s, self.mul(u[..., 2], v[..., 2]))
        return s

    def cross3(self, u, v):
        """Cross product of [..., 3] int arrays over GF(q) (paper eq. (2))."""
        u = np.asarray(u)
        v = np.asarray(v)
        c0 = self.sub(self.mul(u[..., 1], v[..., 2]), self.mul(u[..., 2], v[..., 1]))
        c1 = self.sub(self.mul(u[..., 2], v[..., 0]), self.mul(u[..., 0], v[..., 2]))
        c2 = self.sub(self.mul(u[..., 0], v[..., 1]), self.mul(u[..., 1], v[..., 0]))
        return np.stack([c0, c1, c2], axis=-1)

    def normalize3(self, u):
        """Left-normalize [..., 3] vectors: scale so first nonzero entry is 1.

        All-zero vectors are returned unchanged.
        """
        u = np.asarray(u)
        nz0 = u[..., 0] != 0
        nz1 = (~nz0) & (u[..., 1] != 0)
        nz2 = (~nz0) & (u[..., 1] == 0) & (u[..., 2] != 0)
        lead = np.where(nz0, u[..., 0], np.where(nz1, u[..., 1], np.where(nz2, u[..., 2], 1)))
        scale = self.inv(lead)
        return np.stack([self.mul(u[..., i], scale) for i in range(3)], axis=-1)

    @functools.cached_property
    def squares(self) -> np.ndarray:
        """Set (bool mask over [0,q)) of nonzero quadratic residues."""
        mask = np.zeros(self.q, dtype=bool)
        for x in range(1, self.q):
            mask[self.mul_table[x, x]] = True
        return mask

    def primitive_element(self) -> int:
        """A generator of the multiplicative group GF(q)*."""
        for g in range(2, self.q):
            x, seen = 1, 0
            for _ in range(self.q - 1):
                x = int(self.mul_table[x, g])
                seen += 1
                if x == 1:
                    break
            if seen == self.q - 1:
                return g
        raise ValueError("no primitive element found")
