"""The verifying key, worked out from a circuit's layout and the SRS's secret.

The SRS of a development setup is the powers of a secret s, hashed from the
set-up's seed: s = Blake2b-512(seed) mod r (1 where that is 0), G1 bases
s^i * G and L_i(s) * G.  Knowing s, a commitment to a column given by its n
values in the Lagrange basis is (sum_i f_i * L_i(s)) * G, one scalar
multiplication, with L_i(s) = omega^i (s^n - 1) / (n (s - omega^i)).

The permutation's sigma columns follow halo2's permutation keygen
(permutation/keygen.rs Assembly::copy): every cell starts in a cycle of its
own; a copy merges the smaller cycle into the larger (the left one on a tie)
and swaps the two cells' successors; sigma_c[i] = delta^c' * omega^i' where
(c', i') is the successor of cell (c, i).

The key's hash is Blake2b-512 personalised "Halo2-Verify-Key" over the
length (8 bytes, little-endian) and the text of PinnedVerificationKey's
Rust Debug (plonk.rs), reduced mod r.
"""

from __future__ import annotations

import hashlib

from . import bn254


def toxic_waste(seed: bytes) -> int:
    s = int.from_bytes(hashlib.blake2b(seed, digest_size=64).digest(), "little") % bn254.R
    return s or 1


def lagrange_at(k: int, s: int) -> list:
    """[L_i(s) for i < 2^k], with one batched inversion."""
    r, n = bn254.R, 1 << k
    w = bn254.omega(k)
    pows = [1] * n
    for i in range(1, n):
        pows[i] = pows[i - 1] * w % r
    diffs = [(s - wi) % r for wi in pows]
    prefix = [1] * (n + 1)
    for i, d in enumerate(diffs):
        prefix[i + 1] = prefix[i] * d % r
    inv = pow(prefix[n], -1, r)
    invs = [0] * n
    for i in range(n - 1, -1, -1):
        invs[i] = inv * prefix[i] % r
        inv = inv * diffs[i] % r
    common = (pow(s, n, r) - 1) * pow(n, -1, r) % r
    return [pows[i] * common % r * invs[i] % r for i in range(n)]


def commit_lagrange(values: dict, lag: list):
    """The commitment of a column given as {row: value} (other rows 0)."""
    acc = 0
    for row, v in values.items():
        acc += v * lag[row]
    return bn254.mul(bn254.G1, acc % bn254.R)


def sigma_columns(k: int, columns: list, copies: list) -> list:
    """halo2's permutation assembly; [{row: sigma value}] per permutation
    column, every row of the domain given."""
    r, n = bn254.R, 1 << k
    index = {c: i for i, c in enumerate(columns)}
    mapping = [[(c, i) for i in range(n)] for c in range(len(columns))]
    aux = [[(c, i) for i in range(n)] for c in range(len(columns))]
    sizes = [[1] * n for _ in columns]
    for lcol, lrow, rcol, rrow in copies:
        left, right = (index[lcol], lrow), (index[rcol], rrow)
        lc, rc = aux[left[0]][left[1]], aux[right[0]][right[1]]
        if lc == rc:
            continue
        if sizes[lc[0]][lc[1]] < sizes[rc[0]][rc[1]]:
            lc, rc = rc, lc
        sizes[lc[0]][lc[1]] += sizes[rc[0]][rc[1]]
        i = rc
        while True:
            aux[i[0]][i[1]] = lc
            i = mapping[i[0]][i[1]]
            if i == rc:
                break
        mapping[left[0]][left[1]], mapping[right[0]][right[1]] = (
            mapping[right[0]][right[1]], mapping[left[0]][left[1]])
    w = bn254.omega(k)
    wpow = [1] * n
    for i in range(1, n):
        wpow[i] = wpow[i - 1] * w % r
    dpow = [pow(bn254.DELTA, c, r) for c in range(len(columns))]
    return [{i: dpow[c2] * wpow[i2] % r for i, (c2, i2) in enumerate(col)} for col in mapping]


def point_debug(pt) -> str:
    x, y = pt if pt is not None else (0, 0)
    return f"(0x{x:064x}, 0x{y:064x})"


class VerifyingKey:
    def __init__(self, cs, k: int, fixed: list, permutation: list):
        self.cs = cs
        self.k = k
        self.fixed = fixed  # affine points, one per fixed column
        self.permutation = permutation  # affine points, one per permutation column
        self.repr = self._hash()

    def debug(self) -> str:
        return (
            "PinnedVerificationKey { "
            f'base_modulus: "0x{bn254.P:064x}", scalar_modulus: "0x{bn254.R:064x}", '
            f"domain: PinnedEvaluationDomain {{ k: {self.k}, "
            f"extended_k: {self.cs.extended_k(self.k)}, omega: 0x{bn254.omega(self.k):064x} }}, "
            f"cs: {self.cs.debug()}, "
            "fixed_commitments: [" + ", ".join(map(point_debug, self.fixed)) + "], "
            "permutation: VerifyingKey { commitments: ["
            + ", ".join(map(point_debug, self.permutation)) + "] } }"
        )

    def _hash(self) -> int:
        text = self.debug().encode()
        h = hashlib.blake2b(digest_size=64, person=b"Halo2-Verify-Key")
        h.update(len(text).to_bytes(8, "little"))
        h.update(text)
        return int.from_bytes(h.digest(), "little") % bn254.R


def verifying_key(cs, k: int, fixed_columns: list, copies: list, s: int) -> VerifyingKey:
    """``fixed_columns``: [{row: value}] per fixed column; ``copies``:
    [(column, row, column, row)] in the order the circuit makes them."""
    lag = lagrange_at(k, s)
    fixed = [commit_lagrange(col, lag) for col in fixed_columns]
    sigmas = sigma_columns(k, cs.permutation, copies)
    return VerifyingKey(cs, k, fixed, [commit_lagrange(col, lag) for col in sigmas])
