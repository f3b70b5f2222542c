"""halo2_tpu_torch serde against the JAX package's, byte for byte.

On the ``tests/test_serde_raw.py`` keys (SimpleCircuit, k=4, SRS
``setup_host(4, seed=b"serde-raw-test")``) the port's vk and pk bytes equal
the JAX package's in all three formats, and each package reads the other's
bytes back to the same bytes.  The port rejects what the JAX readers reject
(a raw point off the curve or at the modulus, a scalar at or above p in
Processed and RawBytes, a compressed x at or above p or off the curve) and
reduces an unchecked scalar as they do.  ``ParamsKZG`` bytes equal JAX's
``write`` in every format and read back; ``ParamsIPA`` bytes equal JAX's at
k=3 on Pallas (whose decompression takes the Tonelli-Shanks ladder) and read
back.  Tolerance: exact.
"""

import io

import numpy as np
import pytest
import torch

from circuits import SimpleCircuit as JSimpleCircuit
from halo2_tpu.circuit import Value as JValue
from halo2_tpu.curves import point as jpoint
from halo2_tpu.curves.spec import ALL_CURVES as J_CURVES
from halo2_tpu.curves.spec import BN254_G1 as J_G1
from halo2_tpu.plonk import keygen_pk as j_keygen_pk
from halo2_tpu.plonk import keygen_vk as j_keygen_vk
from halo2_tpu.plonk import serde as jserde
from halo2_tpu.poly import ipa as jipa
from halo2_tpu.poly.kzg import ParamsKZG as JParamsKZG

from halo2_tpu_torch.circuit import Value
from halo2_tpu_torch.curves import host, point
from halo2_tpu_torch.curves.spec import BN254_G1, PALLAS
from halo2_tpu_torch.fields import limb
from halo2_tpu_torch.plonk import keygen_pk, keygen_vk, serde
from halo2_tpu_torch.poly.ipa import ParamsIPA
from halo2_tpu_torch.poly.kzg import ParamsKZG

from torch_circuits import SimpleCircuit

torch.set_num_threads(1)  # tiny limb tensors: one thread is faster, and xdist runs several workers

FORMATS = list(serde.SerdeFormat)
FQ, FR = BN254_G1.base, BN254_G1.scalar


def _jfmt(fmt):
    return jserde.SerdeFormat[fmt.name]


@pytest.fixture(scope="module")
def keys():
    jparams = JParamsKZG.setup_host(4, seed=b"serde-raw-test")
    jcircuit = JSimpleCircuit(7, JValue.unknown())
    jvk = j_keygen_vk(jparams, jcircuit)
    jpk = j_keygen_pk(jparams, jvk, jcircuit)
    params = ParamsKZG.setup_host(4, seed=b"serde-raw-test", device="cpu")
    circuit = SimpleCircuit(7, Value.unknown())
    vk = keygen_vk(params, circuit)
    pk = keygen_pk(params, vk, circuit)
    return {"jvk": jvk, "jpk": jpk, "vk": vk, "pk": pk,
            "jbytes": {f: jserde.pk_to_bytes(jpk, J_G1, _jfmt(f)) for f in FORMATS}}


@pytest.mark.parametrize("fmt", FORMATS, ids=lambda f: f.name)
def test_vk_and_pk_bytes_equal_jax(keys, fmt):
    assert serde.vk_to_bytes(keys["vk"], BN254_G1, fmt) == jserde.vk_to_bytes(
        keys["jvk"], J_G1, _jfmt(fmt))
    assert serde.pk_to_bytes(keys["pk"], BN254_G1, fmt) == keys["jbytes"][fmt]


@pytest.mark.parametrize("fmt", FORMATS, ids=lambda f: f.name)
def test_port_reads_jax_bytes(keys, fmt):
    data = keys["jbytes"][fmt]
    pk = serde.pk_from_bytes(data, BN254_G1, SimpleCircuit, fmt=fmt, device="cpu")
    assert pk.l0.values.device.type == "cpu"
    assert pk.vk.transcript_repr == keys["vk"].transcript_repr == keys["jvk"].transcript_repr
    assert pk.vk.fixed_commitments == keys["jvk"].fixed_commitments
    assert serde.pk_to_bytes(pk, BN254_G1, fmt) == data
    vk = serde.vk_from_bytes(jserde.vk_to_bytes(keys["jvk"], J_G1, _jfmt(fmt)), BN254_G1,
                             SimpleCircuit, fmt=fmt, device="cpu")
    assert vk.transcript_repr == keys["vk"].transcript_repr


@pytest.mark.parametrize("fmt", FORMATS, ids=lambda f: f.name)
def test_jax_reads_port_bytes(keys, fmt):
    data = serde.pk_to_bytes(keys["pk"], BN254_G1, fmt)
    jpk = jserde.pk_from_bytes(data, J_G1, JSimpleCircuit, fmt=_jfmt(fmt))
    assert jpk.vk.transcript_repr == keys["vk"].transcript_repr
    assert jserde.pk_to_bytes(jpk, J_G1, _jfmt(fmt)) == data


def test_serde_defaults_to_the_card():
    import inspect

    for fn in (serde.read_vk, serde.read_pk, serde.vk_from_bytes, serde.pk_from_bytes,
               serde.points_from_bytes, serde.scalars_from_bytes, ParamsIPA.read):
        assert inspect.signature(fn).parameters["device"].default == "cuda", fn.__qualname__


def _jax_point(data: bytes, fmt):
    return jserde._read_point(io.BytesIO(data), J_G1, _jfmt(fmt))


def _port_point(data: bytes, fmt):
    n = len(data) // serde.point_bytes(fmt)
    return point.to_affine_ints(BN254_G1, serde.points_from_bytes(BN254_G1, data, n, fmt, "cpu"))


def test_raw_point_rejects_off_curve_and_overflow():
    g = (BN254_G1.gx, BN254_G1.gy)
    raw = bytearray(serde.points_to_bytes(BN254_G1, point.from_affine_ints(BN254_G1, [g], "cpu"),
                                          serde.SerdeFormat.RAW_BYTES))
    assert bytes(raw) == (FQ.to_mont(g[0]).to_bytes(32, "little")
                          + FQ.to_mont(g[1]).to_bytes(32, "little"))
    for fmt in (serde.SerdeFormat.RAW_BYTES, serde.SerdeFormat.RAW_BYTES_UNCHECKED):
        assert _port_point(bytes(raw), fmt) == [g] == [_jax_point(bytes(raw), fmt)]
    raw[0] ^= 1  # x perturbed: off the curve
    with pytest.raises(ValueError):
        _port_point(bytes(raw), serde.SerdeFormat.RAW_BYTES)
    unchecked = serde.SerdeFormat.RAW_BYTES_UNCHECKED
    assert _port_point(bytes(raw), unchecked) == [_jax_point(bytes(raw), unchecked)]
    # x = p: rejected by RawBytes, reduced to x = 0 by RawBytesUnchecked
    over = FQ.p.to_bytes(32, "little") + bytes(raw[32:])
    with pytest.raises(ValueError):
        _port_point(over, serde.SerdeFormat.RAW_BYTES)
    assert _port_point(over, unchecked) == [_jax_point(over, unchecked)]
    # the identity: 64 zero bytes, in a batch beside a point
    both = bytes(64) + serde.points_to_bytes(
        BN254_G1, point.from_affine_ints(BN254_G1, [g], "cpu"), serde.SerdeFormat.RAW_BYTES)
    assert _port_point(both, serde.SerdeFormat.RAW_BYTES) == [None, g]


def test_compressed_point_checks_match_jax():
    pts = [host.mul(BN254_G1, host.generator(BN254_G1), k) for k in (1, 2, 3, 12345)] + [None]
    data = serde.points_to_bytes(BN254_G1, point.from_affine_ints(BN254_G1, pts, "cpu"),
                                 serde.SerdeFormat.PROCESSED)
    assert data == b"".join(jserde.point_to_bytes(J_G1, p) for p in pts)
    assert _port_point(data, serde.SerdeFormat.PROCESSED) == pts
    # x at the modulus, and an x whose x^3 + 3 is not a square
    x_bad = next(x for x in range(2, 100) if FQ.sqrt((x ** 3 + 3) % FQ.p) is None)
    for bad in (FQ.p.to_bytes(32, "little"), x_bad.to_bytes(32, "little")):
        with pytest.raises(ValueError):
            _jax_point(bad, serde.SerdeFormat.PROCESSED)
        with pytest.raises(ValueError):
            _port_point(data[:32] + bad, serde.SerdeFormat.PROCESSED)


@pytest.mark.parametrize("value", [FR.p, FR.p + 5, (1 << 256) - 1])
def test_scalar_at_or_above_p(value):
    data = value.to_bytes(32, "little") + (7).to_bytes(32, "little")
    for fmt in (serde.SerdeFormat.PROCESSED, serde.SerdeFormat.RAW_BYTES):
        with pytest.raises(ValueError):
            jserde._read_scalar(io.BytesIO(data), FR, _jfmt(fmt))
        with pytest.raises(ValueError):
            serde.scalars_from_bytes(FR, data, 2, fmt, device="cpu")
    unchecked = serde.SerdeFormat.RAW_BYTES_UNCHECKED
    got = serde.scalars_from_bytes(FR, data, 2, unchecked, device="cpu")
    want = [jserde._read_scalar(io.BytesIO(data[i:i + 32]), FR, _jfmt(unchecked)) for i in (0, 32)]
    assert limb.to_ints(FR, got) == want
    assert serde.scalars_to_bytes(FR, got, unchecked)[:32] == (value % FR.p).to_bytes(32, "little")


@pytest.mark.parametrize("fmt", FORMATS, ids=lambda f: f.name)
def test_params_kzg_bytes_equal_jax_and_read_back(tmp_path, fmt):
    params = ParamsKZG.setup_host(3, seed=b"serde-params", device="cpu")
    ours, theirs = tmp_path / "ours.bin", tmp_path / "theirs.bin"
    params.write(str(ours), fmt)
    JParamsKZG.setup_host(3, seed=b"serde-params").write(str(theirs), _jfmt(fmt))
    assert ours.read_bytes() == theirs.read_bytes()
    back = ParamsKZG.read(str(ours), fmt, device="cpu")
    assert (back.k, back.s, back.g2, back.s_g2) == (3, None, params.g2, params.s_g2)
    for name in ("g", "g_lagrange"):
        for a, b in zip(getattr(back, name), getattr(params, name)):
            assert torch.equal(a, b)
    jback = JParamsKZG.read(str(ours), _jfmt(fmt))
    assert jpoint.to_affine_ints(J_G1, jback.g) == point.to_affine_ints(BN254_G1, params.g)


def test_params_kzg_raw_read_rejects_a_flipped_coordinate(tmp_path):
    params = ParamsKZG.setup_host(3, seed=b"serde-params", device="cpu")
    path = tmp_path / "raw.bin"
    params.write(str(path), serde.SerdeFormat.RAW_BYTES)
    data = bytearray(path.read_bytes())
    data[4 + 64 * 5] ^= 1  # the x of g[5]
    path.write_bytes(bytes(data))
    with pytest.raises(ValueError):
        ParamsKZG.read(str(path), serde.SerdeFormat.RAW_BYTES, device="cpu")
    ParamsKZG.read(str(path), serde.SerdeFormat.RAW_BYTES_UNCHECKED, device="cpu")


def test_params_ipa_bytes_equal_jax_and_read_back(tmp_path):
    rs = np.random.default_rng(6)
    g_ = host.generator(PALLAS)
    g, gl = ([host.mul(PALLAS, g_, int(k)) for k in rs.integers(1, 1 << 62, size=8)]
             for _ in range(2))
    w, u = host.mul(PALLAS, g_, 77), host.mul(PALLAS, g_, 78)
    params = ParamsIPA(3, PALLAS, point.from_affine_ints(PALLAS, g, "cpu"),
                       point.from_affine_ints(PALLAS, gl, "cpu"), w, u)
    (jc,) = [c for c in J_CURVES if c.name == PALLAS.name]
    jparams = jipa.ParamsIPA(3, jc, jpoint.from_affine_ints(jc, g),
                             jpoint.from_affine_ints(jc, gl), w, u)
    ours, theirs = tmp_path / "ours.bin", tmp_path / "theirs.bin"
    params.write(str(ours))
    jparams.write(str(theirs))
    assert ours.read_bytes() == theirs.read_bytes()
    back = ParamsIPA.read(str(ours), PALLAS, device="cpu")
    assert (back.k, back.w, back.u) == (3, w, u)
    assert point.to_affine_ints(PALLAS, back.g) == g
    assert point.to_affine_ints(PALLAS, back.g_lagrange) == gl
    for a, b in zip(back.g, params.g):
        assert torch.equal(a, b)
