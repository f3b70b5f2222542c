from .keccak import Keccak256, keccak256
from .transcript import (
    TRANSCRIPTS,
    Blake2bTranscript,
    Keccak256Transcript,
    point_from_bytes,
    point_to_bytes,
    scalar_from_repr,
    scalar_to_repr,
)
