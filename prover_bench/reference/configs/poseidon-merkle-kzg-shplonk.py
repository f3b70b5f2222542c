"""The reference's own account of a Poseidon Merkle root over
``config["leaves"]`` leaves on halo2's Pow5Chip (P128Pow5T3 over BN254's r:
width 3, rate 2, 8 full and 56 partial rounds, ``ConstantLength<2>``), the
circuit of the configuration ``poseidon-merkle-kzg-shplonk``: its constraint
system in the port's query order, its layout under the simple floor planner
and its statement.  Plain Python.  Poseidon's constants and permutation are
written here from the Poseidon paper (Grassi et al., "Poseidon: A New Hash
Function for Zero-Knowledge Proof Systems", appendices on the Grain LFSR and
the MDS matrix), not from the port.

  columns   advice s0, s1, s2 (the state), sbox (the partial S-box); fixed
            rc_a0..2, rc_b0..2, rc_b0 the constants column; one instance
            column.  In the permutation, in this order: rc_b0, the
            instance, s0..s2, rc_b1, rc_b2.
  gates     full round (s_full): for each i, sum_j MDS[i][j] * (s_j +
            rc_a_j)^5 = s_i(next).  Partial rounds, two a row (s_partial):
            (s0 + rc_a0)^5 = sbox; with mid_i = MDS[i][0] * sbox + sum_{j>0}
            MDS[i][j] * (s_j + rc_a_j), (mid_0 + rc_b0)^5 and mid_i + rc_b_i
            (i > 0) equal sum_j MDS^-1[i][j] * s_j(next).  Pad-and-add
            (s_pad_and_add): s_i(prev) + s_i = s_i(next) for the rate, and
            s2(prev) = s2(next).
  regions   every region starts at the first row at which none of its
            columns is in use: the leaves, leaf i in s_(i mod 3) at row
            i // 3; then a hash a node, level by level, left to right: the
            initial state (0, 0, 2^65, each pinned to a constant of the
            constants column, which takes the column's next free rows), the
            pad-and-add (the last state and the two children copied in) and
            the permutation (4 full rounds, 28 rows of two partial rounds, 4
            full rounds, 37 rows).  The root, s0 of the last permutation's
            last row, is copied to instance row 0.
"""

import functools

from prover_bench.reference import bn254, compress_selectors
from prover_bench.reference import cs as E
from prover_bench.reference import cs_selectors

T, RATE = 3, 2
FULL, PARTIAL = 8, 56
CAPACITY = 2 << 64  # ConstantLength<2>: the length times 2^64
STATE = [("advice", i) for i in range(T)]
SBOX = ("advice", T)
RC_A = [("fixed", i) for i in range(T)]
RC_B = [("fixed", T + i) for i in range(T)]
INSTANCE = ("instance", 0)
SELECTORS = ["full", "partial", "pad_and_add"]
PERMUTE_ROWS = FULL // 2 + PARTIAL // 2 + FULL // 2 + 1


# -- Poseidon from the paper -----------------------------------------------------

def grain_bits(field_bits: int):
    """The Grain LFSR's self-shrunk output bits: an 80-bit state initialised
    with the field type (2 bits, 1: a prime field), the S-box (4 bits, 0:
    x^alpha), the field's size in bits (12), t (12), R_F (10), R_P (10) and
    thirty ones; b_(i+80) = b_(i+62) + b_(i+51) + b_(i+38) + b_(i+23) +
    b_(i+13) + b_i; the first 160 bits discarded; then pairs of bits, the
    second given where the first is 1."""
    bits = []
    for value, width in ((1, 2), (0, 4), (field_bits, 12), (T, 12), (FULL, 10), (PARTIAL, 10)):
        bits += [(value >> (width - 1 - i)) & 1 for i in range(width)]
    bits += [1] * 30

    def step():
        new = bits[62] ^ bits[51] ^ bits[38] ^ bits[23] ^ bits[13] ^ bits[0]
        bits.append(new)
        del bits[0]
        return new

    for _ in range(160):
        step()
    while True:
        first, second = step(), step()
        if first:
            yield second


def _element(bits, n: int) -> int:
    """n output bits read most significant first."""
    v = 0
    for _ in range(n):
        v = (v << 1) | next(bits)
    return v


@functools.cache
def constants(r: int = bn254.R):
    """(round constants [R_F + R_P][t], MDS, MDS^-1) over the prime field of
    order ``r`` (BN254's scalar field by default): the round constants by
    rejection sampling, then the Cauchy matrix 1 / (x_i + y_j) from 2t
    further elements taken mod r (drawn again until all 2t are distinct)."""
    n = r.bit_length()
    bits = grain_bits(n)
    rcs = []
    for _ in range(FULL + PARTIAL):
        row = []
        while len(row) < T:
            v = _element(bits, n)
            if v < r:
                row.append(v)
        rcs.append(row)
    while True:
        vals = [_element(bits, n) % r for _ in range(2 * T)]
        if len(set(vals)) == 2 * T:
            break
    xs, ys = vals[:T], vals[T:]
    mds = [[pow(x + y, -1, r) for y in ys] for x in xs]
    return rcs, mds, invert(mds, r)


def invert(m: list, r: int) -> list:
    """The inverse of a square matrix over the field of order ``r``, by
    Gauss-Jordan elimination."""
    size = len(m)
    a = [list(row) + [int(i == j) for j in range(size)] for i, row in enumerate(m)]
    for col in range(size):
        pivot = next(i for i in range(col, size) if a[i][col] % r)
        a[col], a[pivot] = a[pivot], a[col]
        inv = pow(a[col][col], -1, r)
        a[col] = [v * inv % r for v in a[col]]
        for i in range(size):
            if i != col and a[i][col]:
                f = a[i][col]
                a[i] = [(v - f * w) % r for v, w in zip(a[i], a[col])]
    return [row[size:] for row in a]


def permutation(state: list) -> list:
    """Poseidon's permutation: R_F / 2 full rounds, R_P partial rounds, R_F / 2
    full rounds; a round adds its constants, applies x^5 to every element
    (full) or to the first (partial), then multiplies by the MDS matrix."""
    r = bn254.R
    rcs, mds, _ = constants()
    (m00, m01, m02), (m10, m11, m12), (m20, m21, m22) = mds
    s0, s1, s2 = state
    for rnd, (c0, c1, c2) in enumerate(rcs):
        full = rnd < FULL // 2 or rnd >= FULL // 2 + PARTIAL
        x = pow(s0 + c0, 5, r)
        y = pow(s1 + c1, 5, r) if full else s1 + c1
        z = pow(s2 + c2, 5, r) if full else s2 + c2
        s0 = (m00 * x + m01 * y + m02 * z) % r
        s1 = (m10 * x + m11 * y + m12 * z) % r
        s2 = (m20 * x + m21 * y + m22 * z) % r
    return [s0, s1, s2]


def hash2(a: int, b: int) -> int:
    """The sponge over ConstantLength<2>: (a, b, 2^65), permuted; the first
    element."""
    return permutation([a, b, CAPACITY])[0]


def merkle_root(leaves: list) -> int:
    level = list(leaves)
    while len(level) > 1:
        level = [hash2(level[i], level[i + 1]) for i in range(0, len(level), 2)]
    return level[0]


# -- the constraint system -------------------------------------------------------

def _pow5(e):
    e2 = E.mul(e, e)
    return E.mul(E.mul(e2, e2), e)


def _scaled(e, v):
    return ("scaled", e, v)


def _lincomb(terms):
    acc = None
    for term in terms:
        acc = term if acc is None else E.add(acc, term)
    return acc


def _pow5_cs():
    """The constraint system before selector compression, in the port's
    order of columns, queries and gates."""
    _, mds, mds_inv = constants()
    cs = cs_selectors.SelectorCS()
    for _ in range(T + 1):
        cs.column("advice")
    for _ in range(2 * T):
        cs.column("fixed")
    cs.enable_constant(RC_B[0])
    cs.column("instance")
    cs.enable_equality(INSTANCE)
    for col in STATE + RC_B:
        cs.enable_equality(col)
    q = cs.query
    s_full, s_partial, s_pad = (cs.selector() for _ in SELECTORS)

    cur = [q(c) for c in STATE]
    rca = [q(c) for c in RC_A]
    nxt = [q(c, 1) for c in STATE]
    for i in range(T):
        out = _lincomb(_scaled(_pow5(E.add(cur[j], rca[j])), mds[i][j]) for j in range(T))
        cs.gates.append(E.mul(s_full, E.sub(out, nxt[i])))

    rcb = [q(c) for c in RC_B]
    mid_0 = q(SBOX)

    def mid(i):
        return _lincomb([_scaled(mid_0, mds[i][0])]
                        + [_scaled(E.add(cur[j], rca[j]), mds[i][j]) for j in range(1, T)])

    def nxt_lin(i):
        return _lincomb(_scaled(nxt[j], mds_inv[i][j]) for j in range(T))

    cs.gates.append(E.mul(s_partial, E.sub(_pow5(E.add(cur[0], rca[0])), mid_0)))
    cs.gates.append(E.mul(s_partial, E.sub(_pow5(E.add(mid(0), rcb[0])), nxt_lin(0))))
    for i in range(1, T):
        cs.gates.append(E.mul(s_partial, E.sub(E.add(mid(i), rcb[i]), nxt_lin(i))))

    for i in range(RATE):
        prev, now, after = q(STATE[i], -1), q(STATE[i]), q(STATE[i], 1)
        cs.gates.append(E.mul(s_pad, E.sub(E.add(prev, now), after)))
    prev, after = q(STATE[RATE], -1), q(STATE[RATE], 1)
    cs.gates.append(E.mul(s_pad, E.sub(prev, after)))
    return cs


# -- the layout ------------------------------------------------------------------

class _Layout:
    """The simple floor planner over the circuit's regions.  A cell is
    (column, absolute row)."""

    def __init__(self, usable: int):
        self.usable = usable
        self.next_free = {}  # column -> first row not yet used
        self.fixed = {c: {} for c in RC_A + RC_B}
        self.selectors = [set() for _ in SELECTORS]
        self.copies = []

    def region(self, columns: list, rows: int) -> int:
        """Place a region of ``rows`` rows using ``columns``; its first row.
        Each of its columns is in use up to the region's last row."""
        start = max(self.next_free.get(c, 0) for c in columns)
        self.next_free.update(dict.fromkeys(columns, start + rows))
        if start + rows > self.usable:
            raise ValueError("the circuit does not fit the usable rows")
        return start

    def leaves(self, count: int) -> list:
        rows = -(-count // T)
        start = self.region(STATE, rows)
        return [(STATE[i % T], start + i // T) for i in range(count)]

    def initial_state(self) -> list:
        start = self.region(STATE, 1)
        row = self.next_free.get(RC_B[0], 0)
        for i, value in enumerate([0] * RATE + [CAPACITY]):
            self.fixed[RC_B[0]][row + i] = value
            self.copies.append((RC_B[0], row + i, STATE[i], start))
        self.next_free[RC_B[0]] = row + T
        return [(c, start) for c in STATE]

    def pad_and_add(self, state: list, words: list) -> list:
        start = self.region(STATE + [("selector", "pad_and_add")], 3)
        self.selectors[SELECTORS.index("pad_and_add")].add(start + 1)
        for i, (col, row) in enumerate(state):
            self.copies.append((STATE[i], start, col, row))
        for i, (col, row) in enumerate(words):
            self.copies.append((STATE[i], start + 1, col, row))
        return [(c, start + 2) for c in STATE]

    def permute(self, state: list) -> list:
        rcs = constants()[0]
        columns = STATE + [SBOX] + RC_A + RC_B + [("selector", "full"), ("selector", "partial")]
        start = self.region(columns, PERMUTE_ROWS)
        for i, (col, row) in enumerate(state):
            self.copies.append((STATE[i], start, col, row))
        rows = ([("full", rnd) for rnd in range(FULL // 2)]
                + [("partial", FULL // 2 + 2 * j) for j in range(PARTIAL // 2)]
                + [("full", FULL // 2 + PARTIAL + j) for j in range(FULL // 2)])
        for offset, (kind, rnd) in enumerate(rows):
            row = start + offset
            self.selectors[SELECTORS.index(kind)].add(row)
            for i in range(T):
                self.fixed[RC_A[i]][row] = rcs[rnd][i]
                if kind == "partial":
                    self.fixed[RC_B[i]][row] = rcs[rnd + 1][i]
        return [(c, start + PERMUTE_ROWS - 1) for c in STATE]

    def hash(self, left, right):
        state = self.pad_and_add(self.initial_state(), [left, right])
        return self.permute(state)[0]


def _walk(leaves: int, usable: int) -> _Layout:
    lay = _Layout(usable)
    level = lay.leaves(leaves)
    while len(level) > 1:
        level = [lay.hash(level[i], level[i + 1]) for i in range(0, len(level), 2)]
    col, row = level[0]
    lay.copies.append((col, row, INSTANCE, 0))
    return lay


def _layout(config: dict):
    """(the constraint system with its selectors compressed, the walk, the
    compressed selector columns)."""
    cs = _pow5_cs()
    usable = (1 << config["k"]) - (cs.blinding_factors() + 1)
    lay = _walk(config["leaves"], usable)
    selector_columns = compress_selectors.compress(cs, lay.selectors)
    return cs, lay, selector_columns


def constraint_system(config: dict):
    return _layout(config)[0]


def layout(config: dict):
    """(fixed columns as [{row: value}], copies as [(column, row, column, row)])."""
    _, lay, selector_columns = _layout(config)
    fixed = [dict(lay.fixed[c]) for c in RC_A + RC_B] + selector_columns
    return fixed, list(lay.copies)


def instance(config: dict, message: bytes) -> list:
    """[[the Merkle root of the message's leaves]]: leaf i is the message's
    i-th 32-byte little-endian word mod r."""
    size = 32 * config["leaves"]
    if len(message) != size:
        raise ValueError(f"a {len(message)}-byte message is not {config['leaves']} leaves")
    leaves = [int.from_bytes(message[i:i + 32], "little") % bn254.R for i in range(0, size, 32)]
    return [[merkle_root(leaves)]]
