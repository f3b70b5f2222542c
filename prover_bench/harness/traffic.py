"""The one generator of every traffic mix: what each proof of a run proves,
made from the run's seed.

A mix's file (``traffic/<mix>.json``) gives ``loop`` ("closed": the next
proof starts when the last one ends), ``in_flight`` (1) and
``message_bytes``: each proof's message is that many bytes of SHAKE-256 over
the seed and the proof's index, and its blinding rng is seeded from the same
two.  The configuration turns the message into a witness and an instance.
The same seed gives the same messages, the SRS and the blinds; index -1 is
the warm-up proof of set-up.
"""

from __future__ import annotations

import hashlib


def _tag(kind: str, seed: int, index: int | None = None) -> bytes:
    text = f"prover_bench/{kind}/{seed}" + ("" if index is None else f"/{index}")
    return text.encode()


def check(traffic: dict) -> None:
    if traffic.get("loop") != "closed" or traffic.get("in_flight") != 1:
        raise ValueError("the generator serves a closed loop with one proof in flight")
    if int(traffic["message_bytes"]) < 1:
        raise ValueError("message_bytes must be positive")


def message(traffic: dict, seed: int, index: int) -> bytes:
    return hashlib.shake_256(_tag("message", seed, index)).digest(int(traffic["message_bytes"]))


def blind_seed(seed: int, index: int) -> bytes:
    return _tag("blinds", seed, index)


def srs_seed(seed: int) -> bytes:
    return _tag("srs", seed)
