from .spec import (
    ALL_FIELDS,
    BN254_FQ,
    BN254_FR,
    LIMB_BITS,
    LIMB_MASK,
    NLIMBS,
    PASTA_FP,
    PASTA_FQ,
    FieldSpec,
    int_to_limbs,
    limbs_to_int,
)
from . import limb
