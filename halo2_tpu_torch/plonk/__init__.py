from .circuit import (
    ADVICE,
    FIRST_PHASE,
    FIXED,
    INSTANCE,
    SECOND_PHASE,
    THIRD_PHASE,
    Challenge,
    Column,
    Constant,
    ConstraintSystem,
    Expression,
    Gate,
    LookupArgument,
    PermutationArgument,
    Selector,
    TableColumn,
    VirtualCells,
)
from .error import *  # noqa: F401,F403

# keygen/prover/verifier import the circuit-API layer which imports back into
# plonk.circuit; load them lazily (PEP 562) to break the cycle.
_LAZY = {
    "ProvingKey": "keygen",
    "VerifyingKey": "keygen",
    "keygen_pk": "keygen",
    "keygen_vk": "keygen",
    "create_proof": "prover",
    "verify_proof": "verifier",
    "Evaluator": "evaluation",
}


def __getattr__(name):
    if name in _LAZY:
        import importlib

        mod = importlib.import_module(f".{_LAZY[name]}", __name__)
        return getattr(mod, name)
    raise AttributeError(name)
