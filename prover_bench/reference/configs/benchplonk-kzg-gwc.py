"""The reference's own account of ``MyCircuit`` of halo2's
``halo2_proofs/benches/plonk.rs``: its constraint system, its layout and its
statement, written from the source bench, not from the port.

Columns: advice a, b, c (all three in the permutation, in that order), fixed
sa, sb, sc, sm.  One gate: a*sa + b*sb + a*b*sm - c*sc.  The layout, under
halo2's SimpleFloorPlanner: iteration j of (2^(k-1) - 3) puts raw_multiply
(a, a, a^2; sm = sc = 1) on row 2j and raw_add (a, a^2, a^2 + a; sa = sb = sc
= 1) on row 2j+1, then copies a(2j) to a(2j+1) and b(2j+1) to c(2j).  The
circuit has no instance column, so its statement is the empty instance.
"""

from prover_bench.reference import cs as E


def constraint_system(config: dict):
    cs = E.CS()
    a, b, c = (cs.column("advice") for _ in range(3))
    for col in (a, b, c):
        cs.enable_equality(col)
    sa, sb, sc, sm = (cs.column("fixed") for _ in range(4))
    qa, qb, qc = (cs.query(col) for col in (a, b, c))
    qsa, qsb, qsc, qsm = (cs.query(col) for col in (sa, sb, sc, sm))
    cs.gates.append(E.sub(E.add(E.add(E.mul(qa, qsa), E.mul(qb, qsb)), E.mul(E.mul(qa, qb), qsm)),
                          E.mul(qc, qsc)))
    return cs


def layout(config: dict):
    """(fixed columns as [{row: value}], copies as [(column, row, column, row)])."""
    iterations = (1 << (config["k"] - 1)) - 3
    mul_rows = range(0, 2 * iterations, 2)
    add_rows = range(1, 2 * iterations, 2)
    sa = {row: 1 for row in add_rows}
    sc = {row: 1 for row in range(2 * iterations)}
    sm = {row: 1 for row in mul_rows}
    a, b, c = ("advice", 0), ("advice", 1), ("advice", 2)
    copies = []
    for row in mul_rows:
        copies += [(a, row, a, row + 1), (b, row + 1, c, row)]
    return [sa, dict(sa), sc, sm], copies


def instance(config: dict, message: bytes) -> list:
    return []
