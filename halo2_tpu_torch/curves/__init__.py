from .spec import ALL_CURVES, BN254_G1, PALLAS, VESTA, CurveSpec
from .point import (
    Point,
    batch_normalize,
    ec_add,
    ec_double,
    ec_neg,
    ec_select,
    from_affine_ints,
    identity,
    to_affine_ints,
)
from . import host
