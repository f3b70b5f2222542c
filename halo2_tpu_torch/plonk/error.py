"""Error types mirroring the reference plonk/error.rs:11-40."""

from __future__ import annotations


class Halo2Error(Exception):
    pass


class SynthesisError(Halo2Error):
    pass


class InvalidInstances(Halo2Error):
    pass


class ConstraintSystemFailure(Halo2Error):
    pass


class BoundsFailure(Halo2Error):
    pass


class OpeningError(Halo2Error):
    pass


class TranscriptError(Halo2Error):
    pass


class NotEnoughRowsAvailable(Halo2Error):
    def __init__(self, current_k: int):
        self.current_k = current_k
        super().__init__(
            f"k = {current_k} is too small for the given circuit; try increasing it"
        )


class InstanceTooLarge(Halo2Error):
    pass


class NotEnoughColumnsForConstants(Halo2Error):
    pass


class ColumnNotInPermutation(Halo2Error):
    def __init__(self, column):
        self.column = column
        super().__init__(f"column {column} not in permutation argument")
