"""Write the JAX package's pin of the Sinsemilla commit circuit over IPA on Vesta.

    python tests/make_sinsemilla_pin.py --vk     # tests/data/sinsemilla_commit_ipa_k11.vk
    python tests/make_sinsemilla_pin.py          # tests/data/sinsemilla_commit_ipa_k11.hex

The proof of ``tests/test_sinsemilla.py::CommitCircuit`` (a Sinsemilla hash of
the 20-bit message of ``test_commit_domain_circuit`` in the domain
``z.cash:test-commit``, plus the ECC fixed-base mul of its ``r``) over Pallas
Fp, committed by IPA on Vesta with the reference's SRS
(``ParamsIPA.setup(11, VESTA)``), a Blake2b transcript and
``FieldRng(VESTA.scalar, b"sinsemilla-rng")``.  The circuit is subclassed to
enable equality on ``witness_pieces``: the pieces are witnessed there and
copied into the hash region, and a copy on a column outside the permutation
argument cannot be proved.

Only ``halo2_tpu`` makes it; the port's tests read the file and never write it.
The script refuses to overwrite an existing pin, and checks that the proof
verifies before it writes.  ``--vk`` writes ``sinsemilla_commit_ipa_k11.vk``
(the verifying key's ``transcript_repr`` in hex) after keygen alone: the pin
the port's tests and ``chip_smoke.py`` read.  On a CPU the SRS takes ~6 min
and keygen ~15 min; the prove then failed twice on an 8-core CPU host
(XLA:CPU: "LLVM compilation error: Cannot allocate memory").
Not collected by pytest (its name does not start with ``test_``).
"""

import os
import sys
import time

HERE = os.path.dirname(os.path.abspath(__file__))

# The settings of tests/conftest.py: the CPU, a low XLA optimisation level and
# the repo's persistent compile cache (compiles dominate this proof on a CPU).
os.environ["JAX_PLATFORMS"] = "cpu"
os.environ["XLA_FLAGS"] = (os.environ.get("XLA_FLAGS", "")
                           + " --xla_backend_optimization_level=0").strip()

import jax  # noqa: E402

jax.config.update("jax_platforms", "cpu")
jax.config.update("jax_enable_x64", False)
jax.config.update("jax_disable_most_optimizations", True)
jax.config.update("jax_compilation_cache_dir", os.path.join(os.path.dirname(HERE), ".jax_cache"))
jax.config.update("jax_persistent_cache_min_entry_size_bytes", 0)
jax.config.update("jax_persistent_cache_min_compile_time_secs", 0.2)

PIN = os.path.join(HERE, "data", "sinsemilla_commit_ipa_k11.hex")
VK_PIN = os.path.join(HERE, "data", "sinsemilla_commit_ipa_k11.vk")
K = 11
MESSAGE = 0b1011001110_0100110101  # test_sinsemilla.py::test_commit_domain_circuit
R = 0x2C45DEADBEEF1234567890


def main() -> None:
    vk_only = "--vk" in sys.argv[1:]
    out = VK_PIN if vk_only else PIN
    if os.path.exists(out):
        raise SystemExit(f"{out} exists: a pin is never overwritten")
    sys.path[:0] = [os.path.dirname(HERE), HERE]
    from test_sinsemilla import COMMIT_DOMAIN, CommitCircuit

    from halo2_tpu.circuit import Value
    from halo2_tpu.curves import VESTA
    from halo2_tpu.gadgets.sinsemilla.primitives import K as WORD
    from halo2_tpu.gadgets.utilities import i2lebsp
    from halo2_tpu.plonk import create_proof, keygen_pk, keygen_vk, verify_proof
    from halo2_tpu.poly.ipa import IPASingleStrategy, ParamsIPA
    from halo2_tpu.poly.multiopen_ipa import ipa_create_proof, ipa_verify_proof
    from halo2_tpu.transcript import Blake2bTranscript
    from halo2_tpu.utils.rng import FieldRng

    class ProvedCommitCircuit(CommitCircuit):
        def without_witnesses(self):
            return ProvedCommitCircuit([Value.unknown()] * len(self.bits), Value.unknown(),
                                       self.expected)

        @classmethod
        def configure(cls, meta):
            config = super().configure(meta)
            meta.enable_equality(config[0].witness_pieces)
            return config

    bits = i2lebsp(MESSAGE, 2 * WORD)
    circuit = ProvedCommitCircuit([Value.known(b) for b in bits], Value.known(R),
                                  COMMIT_DOMAIN.commit(bits, R))
    t0 = time.time()
    params = ParamsIPA.setup(K, VESTA)
    print(f"setup {time.time() - t0:.1f} s", flush=True)
    t0 = time.time()
    vk = keygen_vk(params, circuit.without_witnesses())
    print(f"keygen_vk {time.time() - t0:.1f} s; transcript_repr {vk.transcript_repr:#x}", flush=True)
    if vk_only:
        with open(out, "x") as f:
            f.write(f"{vk.transcript_repr:064x}\n")
        print(f"wrote {out}")
        return
    t0 = time.time()
    pk = keygen_pk(params, vk, circuit.without_witnesses())
    print(f"keygen_pk {time.time() - t0:.1f} s", flush=True)
    t0 = time.time()
    proof = create_proof(params, pk, [circuit], [[]], FieldRng(VESTA.scalar, b"sinsemilla-rng"),
                         Blake2bTranscript(VESTA), ipa_create_proof, query_instance=True)
    print(f"create_proof {time.time() - t0:.1f} s", flush=True)
    if not verify_proof(params, vk, [[]], Blake2bTranscript(VESTA, proof), ipa_verify_proof,
                        query_instance=True, strategy=IPASingleStrategy(params)):
        raise SystemExit("the JAX package's Sinsemilla commit proof does not verify")
    with open(out, "x") as f:
        f.write(proof.hex() + "\n")
    print(f"wrote {out}: {len(proof)} bytes")


if __name__ == "__main__":
    main()
