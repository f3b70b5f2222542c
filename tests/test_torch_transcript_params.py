"""halo2_tpu_torch transcripts and KZG params against the JAX package.

The transcripts must give the same bytes and the same challenges over one
recorded write / squeeze sequence; the port's host SRS must equal the JAX
package's, carried across with ``params_from_numpy``, and the numpy round
trip must hold.  Tolerance: exact.
"""

import numpy as np
import pytest
import torch

from halo2_tpu.curves import host as jhost
from halo2_tpu.curves.spec import BN254_G1 as J_G1
from halo2_tpu.poly.kzg import ParamsKZG as JParamsKZG
from halo2_tpu.transcript import TRANSCRIPTS as J_TRANSCRIPTS

from halo2_tpu_torch.curves.spec import BN254_G1
from halo2_tpu_torch.poly.kzg import ParamsKZG, params_from_numpy, params_to_numpy
from halo2_tpu_torch.transcript import TRANSCRIPTS

torch.set_num_threads(1)  # tiny limb tensors: one thread is faster, and xdist runs several workers

P = BN254_G1.scalar.p


def _script(tr, curve, host):
    """One recorded sequence of writes and squeezes; returns the challenges."""
    g = host.generator(curve)
    out = []
    tr.common_scalar(12345)
    out.append(tr.squeeze_challenge())
    for i in range(3):
        tr.write_point(host.mul(curve, g, 7 + i))
        tr.write_scalar((P - 1 - i) % P)
        out.append(tr.squeeze_challenge())
    tr.common_point(host.mul(curve, g, 99))
    out.append(tr.squeeze_challenge())
    return out


@pytest.mark.parametrize("kind", ["blake2b", "keccak256"])
def test_transcript_matches_jax(kind):
    from halo2_tpu_torch.curves import host

    jt = J_TRANSCRIPTS[kind](J_G1)
    tt = TRANSCRIPTS[kind](BN254_G1)
    assert _script(tt, BN254_G1, host) == _script(jt, J_G1, jhost)
    proof = tt.finalize()
    assert proof == jt.finalize()
    # the verifier side reads the same points and scalars back
    rd = TRANSCRIPTS[kind](BN254_G1, proof)
    rd.common_scalar(12345)
    rd.squeeze_challenge()
    for i in range(3):
        assert rd.read_point() == host.mul(BN254_G1, host.generator(BN254_G1), 7 + i)
        assert rd.read_scalar() == (P - 1 - i) % P
        rd.squeeze_challenge()


def _jax_state(params) -> dict:
    def coords(pt):
        return tuple(np.asarray(c) for c in pt)

    def g2(pt):
        return ((pt[0].c0, pt[0].c1), (pt[1].c0, pt[1].c1))

    return {
        "k": params.k,
        "g": coords(params.g),
        "g_lagrange": coords(params.g_lagrange),
        "g2": g2(params.g2),
        "s_g2": g2(params.s_g2),
        "s": params._s,
    }


def _assert_state_equal(a: dict, b: dict):
    assert a.keys() == b.keys()
    for key in a:
        if key in ("g", "g_lagrange"):
            for x, y in zip(a[key], b[key]):
                np.testing.assert_array_equal(
                    np.asarray(x).astype(np.int64), np.asarray(y).astype(np.int64)
                )
        else:
            assert a[key] == b[key], key


def test_setup_host_matches_jax_and_roundtrips(tmp_path):
    state = _jax_state(JParamsKZG.setup_host(4, seed=b"params-test"))
    ported = ParamsKZG.setup_host(4, seed=b"params-test")
    _assert_state_equal(params_to_numpy(ported), state)
    _assert_state_equal(params_to_numpy(params_from_numpy(state)), state)
    # and through the compressed file format
    path = tmp_path / "srs.bin"
    ported.write(str(path))
    back = ParamsKZG.read(str(path))
    assert back.s is None
    state_no_s = dict(state, s=None)
    _assert_state_equal(params_to_numpy(back), state_no_s)
