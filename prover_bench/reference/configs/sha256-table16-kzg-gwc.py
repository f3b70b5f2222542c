"""The reference's own account of the port's SHA-256 Table16 circuit hashing
``config["blocks"]`` blocks (``configuration sha256-table16-kzg-gwc``): its
constraint system in query order, its layout under the simple floor planner
and its statement.  Plain Python: SHA-256's constants are worked out here
from the primes, the instance from ``hashlib``.

The layout, one (tag, dense, spread) lookup row per 16-bit quantity:

  columns   advice tag, dense, spread, aux0..aux3, carry; fixed add_const,
            the table's tag, dense and spread, the constants column; one
            instance column.  In the permutation, in this order: dense,
            spread, aux0..aux3, the constants column, the instance column.
  lookup    (tag, dense, spread) at the current row into the table columns.
  gates     sigma_0, sigma_1, Sigma_0, Sigma_1: a 32-bit word's aux0 halves
            cut into four pieces at the rotation boundaries (recompose; the
            coefficient-weighted spread pieces equal even + 2 * odd of the
            output's four rows; a tag bound for widths 7, 10, 11, 13; one
            more lookup row of piece * 2^(16 - w) for every other width
            below 16).  Ch's P and Q and Maj: spread sums of two or three
            words in aux against the four output rows.  add2, add2c (with
            add_const), add3, add4: operand halves in aux, result halves in
            two lookup rows, the carry in carry with a range product.
  regions   every region starts where the last ended (each one's lookup
            rows start at its row 0): the 2^16-row table in the table
            columns; the eight IV words, each pinned to two constants;
            then a block: its 16 words, 48 schedule steps (sigma_0,
            sigma_1, add4), 64 rounds (Sigma_1, Ch P, Ch Q, add4, add2c,
            Sigma_0, Maj, add2, add3) and 8 feed-forward add2.  The digest's
            halves are copied to instance rows 0..15.
"""

import hashlib
from math import isqrt

from prover_bench.reference import compress_selectors
from prover_bench.reference import cs as E
from prover_bench.reference import cs_selectors

M32 = 0xFFFFFFFF
TAG_BOUNDS = (7, 10, 11, 13, 14)  # a value's tag: the first bound in bits it is below
TAG_FOR_WIDTH = {7: 0, 10: 1, 11: 2, 13: 3}  # widths bounded by a tag product


def _primes(count: int) -> list:
    out, c = [], 2
    while len(out) < count:
        if all(c % p for p in out):
            out.append(c)
        c += 1
    return out


def _icbrt(x: int) -> int:
    lo, hi = 0, 1 << (x.bit_length() // 3 + 1)
    while lo < hi:
        mid = (lo + hi + 1) // 2
        if mid ** 3 <= x:
            lo = mid
        else:
            hi = mid - 1
    return lo


# FIPS 180-4: the fractional parts of the square roots of the first 8 primes
# and of the cube roots of the first 64, to 32 bits
IV = [isqrt(p << 64) & M32 for p in _primes(8)]
ROUND_CONSTANTS = [_icbrt(p << 96) & M32 for p in _primes(64)]


def spread(x: int) -> int:
    return int("".join(b + "0" for b in f"{x:016b}"), 2) >> 1


def tag(x: int) -> int:
    return next((i for i, bits in enumerate(TAG_BOUNDS) if x < 1 << bits), len(TAG_BOUNDS))


class Pattern:
    """A sigma: the piece widths (low to high), right rotations, right shift."""

    def __init__(self, key, widths, rotations, shift=None):
        self.key, self.widths, self.rotations, self.shift = key, widths, rotations, shift
        self.offsets = [sum(widths[:i]) for i in range(len(widths))]
        self.shifted = [i for i, w in enumerate(widths) if w < 16 and w not in TAG_FOR_WIDTH]
        self.rows = len(widths) + 4 + len(self.shifted)

    def coeff(self, i: int) -> int:
        off = self.offsets[i]
        c = sum(4 ** ((off - r) % 32) for r in self.rotations)
        if self.shift is not None and off >= self.shift:
            c += 4 ** (off - self.shift)
        return c


SIGMA_0 = Pattern("sigma_0", (3, 4, 11, 14), (7, 18), 3)
SIGMA_1 = Pattern("sigma_1", (10, 7, 2, 13), (17, 19), 10)
BIG_SIGMA_0 = Pattern("Sigma_0", (2, 11, 9, 10), (2, 13, 22))
BIG_SIGMA_1 = Pattern("Sigma_1", (6, 5, 14, 7), (6, 11, 25))
SELECTORS = ["sigma_0", "sigma_1", "Sigma_0", "Sigma_1", "ch_p", "ch_q", "maj",
             "add2", "add2c", "add3", "add4"]
ADDS = {"add2": (2, False, 1), "add2c": (2, True, 2), "add3": (3, False, 2), "add4": (4, False, 3)}

TAG, DENSE, SPREAD = ("advice", 0), ("advice", 1), ("advice", 2)
AUX = [("advice", 3 + j) for j in range(4)]
CARRY = ("advice", 7)
ADD_CONST, TABLE, CONSTANTS = ("fixed", 0), [("fixed", 1 + j) for j in range(3)], ("fixed", 4)
INSTANCE = ("instance", 0)


def _add(a, b):
    return ("sum", a, b)


def _sub(a, b):
    return ("sum", a, ("neg", b))


def _scaled(a, v):
    return ("scaled", a, v)


def _const(v):
    return ("const", v)


def _table16_cs():
    """The constraint system before selector compression, in the port's
    order of columns, queries, gates and the lookup."""
    cs = cs_selectors.SelectorCS()
    for _ in range(8):
        cs.column("advice")
    cs.column("fixed")  # add_const
    for col in [DENSE, SPREAD] + AUX:
        cs.enable_equality(col)
    q = cs.query
    inputs = [q(TAG), q(DENSE), q(SPREAD)]
    for _ in range(3):
        cs.column("fixed")
    cs.lookups.append((inputs, [q(col) for col in TABLE]))
    cs.column("fixed")
    cs.enable_constant(CONSTANTS)

    def spread_out():
        e0, e1, o0, o1 = (q(SPREAD, r) for r in range(4))
        return _add(_add(_add(e0, _scaled(e1, 4 ** 16)), _scaled(o0, 2)),
                    _scaled(o1, 2 * 4 ** 16))

    def word(j):
        return _add(q(AUX[j], 0), _scaled(q(AUX[j], 1), 4 ** 16))

    for pat in (SIGMA_0, SIGMA_1, BIG_SIGMA_0, BIG_SIGMA_1):
        s = cs.selector()
        n = len(pat.widths)
        recomp = None
        for i, off in enumerate(pat.offsets):
            term = _scaled(q(DENSE, i), 1 << off)
            recomp = term if recomp is None else _add(recomp, term)
        x_in = _add(q(AUX[0], 0), _scaled(q(AUX[0], 1), 1 << 16))
        polys = [E.mul(s, _sub(recomp, x_in))]
        ssum = None
        for i in range(n):
            term = _scaled(q(SPREAD, i), pat.coeff(i))
            ssum = term if ssum is None else _add(ssum, term)
        e0, e1, o0, o1 = (q(SPREAD, n + r) for r in range(4))
        out = _add(_add(_add(e0, _scaled(e1, 4 ** 16)), _scaled(o0, 2)), _scaled(o1, 2 * 4 ** 16))
        polys.append(E.mul(s, _sub(ssum, out)))
        for i, w in enumerate(pat.widths):
            if w in TAG_FOR_WIDTH:
                poly = None
                for j in range(TAG_FOR_WIDTH[w] + 1):
                    f = _sub(q(TAG, i), _const(j))
                    poly = f if poly is None else E.mul(poly, f)
                polys.append(E.mul(s, poly))
        for row, i in enumerate(pat.shifted, start=n + 4):
            polys.append(E.mul(s, _sub(q(DENSE, row), _scaled(q(DENSE, i), 1 << (16 - pat.widths[i])))))
        cs.gates += polys

    ones = spread(0xFFFF) * (1 + 4 ** 16)
    s = cs.selector()  # the selectors are made in SELECTORS' order
    cs.gates.append(E.mul(s, _sub(_add(word(0), word(1)), spread_out())))
    s = cs.selector()
    not_e = _sub(_const(ones), word(0))
    cs.gates.append(E.mul(s, _sub(_add(not_e, word(1)), spread_out())))
    s = cs.selector()
    lhs = _add(_add(word(0), word(1)), word(2))
    cs.gates.append(E.mul(s, _sub(lhs, spread_out())))

    for nops, with_const, max_carry in ADDS.values():
        s = cs.selector()
        total = None
        for j in range(nops):
            term = _add(q(AUX[j], 0), _scaled(q(AUX[j], 1), 1 << 16))
            total = term if total is None else _add(total, term)
        if with_const:
            total = _add(total, q(ADD_CONST))
        res = _add(q(DENSE, 0), _scaled(q(DENSE, 1), 1 << 16))
        cy = q(CARRY)
        rangep = None
        for j in range(max_carry + 1):
            f = _sub(cy, _const(j))
            rangep = f if rangep is None else E.mul(rangep, f)
        cs.gates += [E.mul(s, _sub(_sub(total, res), _scaled(cy, 1 << 32))), E.mul(s, rangep)]

    cs.column("instance")
    cs.enable_equality(INSTANCE)
    return cs


class _Layout:
    """The simple floor planner over the circuit's regions: each region
    starts at the first row at which none of its columns is in use.  A word
    is the pair of absolute rows of its lo and hi lookup rows."""

    def __init__(self, usable: int):
        self.usable = usable
        self.next_free = {}  # column -> first row not yet used
        self.selectors = [set() for _ in SELECTORS]
        self.add_const = {}
        self.constants = {}
        self.copies = []

    def region(self, columns: dict) -> int:
        """Place a region using {column: rows}; its first row."""
        start = max(self.next_free.get(c, 0) for c in columns)
        for c, rows in columns.items():
            self.next_free[c] = start + rows
        if start + max(columns.values()) > self.usable:
            raise ValueError("the circuit does not fit the usable rows")
        return start

    def lookup_rows(self, rows: int, extra: dict):
        return {**extra, TAG: rows, DENSE: rows, SPREAD: rows}

    def word(self, pin=None):
        start = self.region(self.lookup_rows(2, {}))
        if pin is not None:
            for row, half in ((start, pin & 0xFFFF), (start + 1, pin >> 16)):
                at = self.next_free.get(CONSTANTS, 0)
                self.constants[at] = half
                self.copies.append((CONSTANTS, at, DENSE, row))
                self.next_free[CONSTANTS] = at + 1
        return (start, start + 1)

    def _operands(self, start, words, column):
        for j, (lo, hi) in enumerate(words):
            self.copies += [(AUX[j], start, column, lo), (AUX[j], start + 1, column, hi)]

    def sigma(self, pat: Pattern, x):
        key = ("selector", pat.key)
        start = self.region(self.lookup_rows(pat.rows, {key: 1, AUX[0]: 2}))
        self.selectors[SELECTORS.index(pat.key)].add(start)
        self._operands(start, [x], DENSE)
        n = len(pat.widths)
        return (start + n, start + n + 1)

    def spread_sum(self, key: str, words):
        extra = {("selector", key): 1, **{AUX[j]: 2 for j in range(len(words))}}
        start = self.region(self.lookup_rows(4, extra))
        self.selectors[SELECTORS.index(key)].add(start)
        self._operands(start, words, SPREAD)
        return (start + 2, start + 3)  # the odd half's word

    def add(self, words, const: int = 0):
        key = "add2c" if const else {2: "add2", 3: "add3", 4: "add4"}[len(words)]
        extra = {("selector", key): 1, CARRY: 1, **{AUX[j]: 2 for j in range(len(words))}}
        if const:
            extra[ADD_CONST] = 1
        start = self.region(self.lookup_rows(2, extra))
        self.selectors[SELECTORS.index(key)].add(start)
        self._operands(start, words, DENSE)
        if const:
            self.add_const[start] = const
        return (start, start + 1)


def _walk(blocks: int, usable: int) -> _Layout:
    """Sha256's regions over ``blocks`` blocks, in the circuit's order."""
    lay = _Layout(usable)
    state = [lay.word(pin=v) for v in IV]
    for _ in range(blocks):
        w = [lay.word() for _ in range(16)]
        for t in range(16, 64):
            s0 = lay.sigma(SIGMA_0, w[t - 15])
            s1 = lay.sigma(SIGMA_1, w[t - 2])
            w.append(lay.add([s1, w[t - 7], s0, w[t - 16]]))
        a, b, c, d, e, f, g, h = state
        for t in range(64):
            sig1 = lay.sigma(BIG_SIGMA_1, e)
            p_odd = lay.spread_sum("ch_p", [e, f])
            q_odd = lay.spread_sum("ch_q", [e, g])
            t1a = lay.add([h, sig1, p_odd, q_odd])
            t1 = lay.add([t1a, w[t]], const=ROUND_CONSTANTS[t])
            sig0 = lay.sigma(BIG_SIGMA_0, a)
            m_odd = lay.spread_sum("maj", [a, b, c])
            e_new = lay.add([d, t1])
            a_new = lay.add([t1, sig0, m_odd])
            a, b, c, d, e, f, g, h = a_new, a, b, c, e_new, e, f, g
        state = [lay.add([state[i], v]) for i, v in enumerate([a, b, c, d, e, f, g, h])]
    for i, (lo, hi) in enumerate(state):
        lay.copies += [(DENSE, lo, INSTANCE, 2 * i), (DENSE, hi, INSTANCE, 2 * i + 1)]
    return lay


def _layout(config: dict):
    """(the constraint system with its selectors compressed, the walk, the
    usable rows, the compressed selector columns)."""
    cs = _table16_cs()
    usable = (1 << config["k"]) - (cs.blinding_factors() + 1)
    lay = _walk(config["blocks"], usable)
    selector_columns = compress_selectors.compress(cs, lay.selectors)
    return cs, lay, usable, selector_columns


def constraint_system(config: dict):
    return _layout(config)[0]


def layout(config: dict):
    """(fixed columns as [{row: value}], copies as [(column, row, column, row)])."""
    _, lay, usable, selector_columns = _layout(config)
    table = [[tag(d) for d in range(1 << 16)], list(range(1 << 16)),
             [spread(d) for d in range(1 << 16)]]
    table_columns = []
    for values in table:
        col = dict(enumerate(values))
        col.update(dict.fromkeys(range(len(values), usable), values[0]))  # padded with row 0's
        table_columns.append(col)
    fixed = [dict(lay.add_const)] + table_columns + [dict(lay.constants)] + selector_columns
    return fixed, list(lay.copies)


def instance(config: dict, message: bytes) -> list:
    """[the digest's 16 half-words: lo then hi of each big-endian word]."""
    digest = hashlib.sha256(message).digest()
    halves = []
    for i in range(8):
        word = int.from_bytes(digest[4 * i:4 * i + 4], "big")
        halves += [word & 0xFFFF, word >> 16]
    return [halves]
