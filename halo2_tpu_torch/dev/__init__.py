from .cost import CircuitCost, MarginalProofSize, ProofSize
from .failure import FailureLocation
from .graph import CircuitLayout, circuit_dot_graph
from .gates import CircuitGates
from .mock_prover import MockProver, VerifyFailure

__all__ = [
    "CircuitCost",
    "CircuitLayout",
    "FailureLocation",
    "circuit_dot_graph",
    "CircuitGates",
    "MarginalProofSize",
    "MockProver",
    "ProofSize",
    "VerifyFailure",
]
