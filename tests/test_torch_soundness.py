"""The gadget soundness regressions of tests/test_soundness_regressions.py, on halo2_tpu_torch.

The short range check reads its 2^-num_bits multiplier from an advice cell
that keygen copy-constrains to a fixed constant: the honest circuit's keygen
records that copy, as the JAX package's does, so a forged multiplier breaks
the permutation argument and its IPA proof is rejected.  The short fixed-base
mul's last window is copy-constrained on the ``u`` column.  The keygen
layouts are held to the JAX package's, array for array.
"""

import numpy as np
import pytest
import torch

import test_soundness_regressions as jsound
import torch_circuits as tc
from halo2_tpu.circuit import Value as JV
from halo2_tpu.circuit.layouter import SimpleFloorPlanner as JaxSimpleFloorPlanner
from halo2_tpu.plonk.circuit import ConstraintSystem as JaxConstraintSystem
from halo2_tpu.plonk.keygen import KeygenAssembly as JaxKeygenAssembly
from halo2_tpu_torch.circuit import SimpleFloorPlanner, Value
from halo2_tpu_torch.curves.spec import PALLAS
from halo2_tpu_torch.plonk.circuit import ConstraintSystem
from halo2_tpu_torch.plonk.keygen import KeygenAssembly

torch.set_num_threads(1)  # small limb tensors; xdist runs several workers

SPEC = PALLAS.scalar


def _assembly(cs_cls, assembly_cls, planner, circuit, k):
    cs = cs_cls()
    config = type(circuit).configure(cs)
    assembly = assembly_cls(k, cs, 1 << k)
    planner.synthesize(assembly, circuit, config, list(cs.constants))
    return config, assembly


def _moved(assembly, column):
    """The rows of ``column`` that keygen put in a copy cycle."""
    perm = assembly.permutation
    m = perm.columns.index(column)  # raises if the column has no equality
    return np.flatnonzero(perm.mapping[m] != np.arange(m * perm.n, (m + 1) * perm.n))


def test_short_check_multiplier_is_copy_constrained():
    """Honest keygen copies the multiplier cell (row 2 of the region) to the
    constants column, as the JAX package's does."""
    config, a = _assembly(ConstraintSystem, KeygenAssembly, SimpleFloorPlanner,
                          tc.ShortCheckCircuit(Value.unknown()), 6)
    _, ja = _assembly(JaxConstraintSystem, JaxKeygenAssembly, JaxSimpleFloorPlanner,
                      jsound.ShortCheckCircuit(JV.unknown()), 6)
    assert np.array_equal(a.permutation.mapping, ja.permutation.mapping)
    assert list(_moved(a, config.running_sum)) == [2]


def test_short_mul_copies_last_window():
    """The short fixed-base mul's last-window cell in the u column is copied
    from the running sum's z_21 (short.rs:173-176), in both packages."""
    config, a = _assembly(ConstraintSystem, KeygenAssembly, SimpleFloorPlanner,
                          tc.ShortMulCircuit(Value.known((100, 1))), 9)
    assert len(_moved(a, config.u)) > 0, "the short mul's last window is unbound"

    from halo2_tpu.curves import PALLAS as JAX_PALLAS
    from halo2_tpu.gadgets.ecc import EccChip as JaxEccChip
    from halo2_tpu.gadgets.ecc.mul_fixed import MulFixedChip as JaxMulFixedChip

    class JaxShortMulCircuit(jsound.Circuit):  # tests/test_soundness_regressions.py's
        floor_planner = JaxSimpleFloorPlanner

        def __init__(self, mag_sign):
            self.mag_sign = mag_sign

        def without_witnesses(self):
            return JaxShortMulCircuit(JV.unknown())

        @classmethod
        def configure(cls, meta):
            advices = [meta.advice_column() for _ in range(11)]
            constants = meta.fixed_column()
            meta.enable_constant(constants)
            ecc = JaxEccChip.configure(meta, advices[:9])
            return JaxMulFixedChip.configure(meta, ecc, advices[9], advices[10])

        def synthesize(self, config, layouter):
            JaxMulFixedChip(config).mul_short(layouter, self.mag_sign,
                                              (JAX_PALLAS.gx, JAX_PALLAS.gy))

    jconfig, ja = _assembly(JaxConstraintSystem, JaxKeygenAssembly, JaxSimpleFloorPlanner,
                            JaxShortMulCircuit(JV.known((100, 1))), 9)
    assert np.array_equal(a.permutation.mapping, ja.permutation.mapping)
    assert np.array_equal(_moved(a, config.u), _moved(ja, jconfig.u))


@pytest.fixture(scope="module")
def keys():
    from halo2_tpu_torch.plonk import keygen_pk, keygen_vk
    from halo2_tpu_torch.poly.ipa import ParamsIPA

    params = ParamsIPA.setup(6, seed=b"soundness-test", device="cpu")
    empty = tc.ShortCheckCircuit(Value.unknown())
    vk = keygen_vk(params, empty)
    return params, vk, keygen_pk(params, vk, empty)


def _prove_and_verify(keys, circuit) -> bool:
    from halo2_tpu_torch.plonk import create_proof, verify_proof
    from halo2_tpu_torch.poly.ipa import IPASingleStrategy
    from halo2_tpu_torch.poly.multiopen_ipa import ipa_create_proof, ipa_verify_proof
    from halo2_tpu_torch.transcript import Blake2bTranscript
    from halo2_tpu_torch.utils.rng import FieldRng

    params, vk, pk = keys
    proof = create_proof(params, pk, [circuit], [[]], FieldRng(SPEC, b"soundness-rng"),
                         Blake2bTranscript(params.curve), ipa_create_proof, query_instance=True)
    return verify_proof(params, vk, [[]], Blake2bTranscript(params.curve, proof),
                        ipa_verify_proof, query_instance=True,
                        strategy=IPASingleStrategy(params))


@pytest.mark.slow
def test_honest_short_check_verifies(keys):
    assert _prove_and_verify(keys, tc.ShortCheckCircuit(Value.known(5)))


@pytest.mark.slow
def test_forged_short_check_multiplier_rejected(keys):
    """Value 9 against a 3-bit claim, with a forged multiplier: the copy to
    the constant breaks the permutation argument."""
    assert not _prove_and_verify(keys, tc.ForgedShortCheckCircuit(Value.unknown()))
