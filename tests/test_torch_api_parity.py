"""The port's public surface against the JAX package's, by ``ast`` alone.

For every module of ``halo2_tpu/`` the module of the same relative path in
``halo2_tpu_torch/`` must define each public module-level def, class and
constant, and each public or dunder method, by the same name; and each
function's leading parameter names must be the JAX function's.  The port's
``device`` / ``mesh`` / ``log`` / ``devices`` parameters are skipped where
they stand.  Neither package is imported, so the test costs milliseconds.
One case a JAX module.  What has no counterpart by design is in the
allowlists below, each with its reason; an entry that the port gains, or
that the JAX package loses, fails the test, so the lists cannot go stale.
"""

import ast
import os

import pytest

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
JAX_PKG = os.path.join(ROOT, "halo2_tpu")
PORT_PKG = os.path.join(ROOT, "halo2_tpu_torch")

# JAX modules with no port: the TPU's layout and kernels, which the CUDA
# kernels of halo2_tpu_torch/csrc replace, and the XLA compile cache
NO_PORT_MODULES = {
    "fields/vreg.py": "the TPU's (8, 128) vreg layout of limb arrays",
    "fields/pallas_kernels.py": "the Pallas Montgomery kernels; csrc/mont_mul.cu, "
                                "mont_mul_tiled.cu, field_ops.cu and ntt.cu replace them",
    "curves/pallas_ec.py": "the Pallas EC add / double; csrc/ec.cu and msm.cu replace them",
    "utils/cache.py": "the XLA persistent compile cache; torch compiles nothing",
}
# names of ported modules with no counterpart
NO_PORT_NAMES = {
    "fields/limb.py": {"U32": "the TPU's uint32 limb dtype; the port keeps int32 limbs "
                              "(limb.DTYPE), as CPU torch has no uint32 + - >>"},
    "ops/msm.py": {"LANES": "the TPU's 128-lane width, a padding unit of the JAX MSM"},
    "poly/polynomial.py": {
        "Poly.tree_flatten": "the JAX pytree registration of Poly",
        "Poly.tree_unflatten": "the JAX pytree registration of Poly",
    },
}
# parameters of a JAX function with no counterpart
NO_PORT_PARAMS = {
    ("ops/msm.py", "msm"): {"window_batch": "the TPU's memory knob: windows per XLA step"},
}
# the port's own parameters, skipped where they stand
PORT_PARAMS = {"device", "mesh", "log", "devices"}
# documented renames: the port's MSMs take the curve, where the JAX ones
# take its spec under the name ``spec``
RENAMES = {
    ("ops/msm.py", "msm"): {"spec": "curve"},
    ("ops/msm.py", "msm_many"): {"spec": "curve"},
    ("parallel/msm.py", "sharded_msm"): {"spec": "curve"},
}


def _modules(pkg: str) -> list:
    out = []
    for root, _, files in os.walk(pkg):
        out += [os.path.relpath(os.path.join(root, f), pkg).replace(os.sep, "/")
                for f in files if f.endswith(".py")]
    return sorted(out)


def _public(name: str) -> bool:
    return all(not part.startswith("_") or (part.startswith("__") and part.endswith("__"))
               for part in name.split("."))


def _params(fn) -> list:
    a = fn.args
    return [p.arg for p in a.posonlyargs + a.args + a.kwonlyargs]


def surface(path: str) -> dict:
    """{public name: its parameter names (a function) or None}: module-level
    defs, classes and assigned names, and each class's methods as
    ``Class.method``."""
    with open(path) as f:
        tree = ast.parse(f.read())
    out = {}
    for node in tree.body:
        if isinstance(node, (ast.FunctionDef, ast.AsyncFunctionDef)):
            out[node.name] = _params(node)
        elif isinstance(node, ast.ClassDef):
            out[node.name] = None
            for item in node.body:
                if isinstance(item, (ast.FunctionDef, ast.AsyncFunctionDef)):
                    out[f"{node.name}.{item.name}"] = _params(item)
        elif isinstance(node, ast.Assign):
            out.update((t.id, None) for t in node.targets if isinstance(t, ast.Name))
        elif isinstance(node, ast.AnnAssign) and isinstance(node.target, ast.Name):
            out[node.target.id] = None
    return {name: v for name, v in out.items() if _public(name)}


def check_module(rel: str, jax_pkg: str = JAX_PKG, port_pkg: str = PORT_PKG) -> list:
    """The differences of one JAX module's surface from its port's, as lines."""
    port_path = os.path.join(port_pkg, rel)
    if rel in NO_PORT_MODULES:
        return [f"{rel}: ported, but allowlisted as having no port"] if os.path.exists(
            port_path) else []
    if not os.path.exists(port_path):
        return [f"{rel}: no such module in the port"]
    jax, port = surface(os.path.join(jax_pkg, rel)), surface(port_path)
    allowed = NO_PORT_NAMES.get(rel, {})
    problems = [f"{rel}: allowlisted {name} is not in the JAX module"
                for name in allowed if name not in jax]
    problems += [f"{rel}: allowlisted {name} is in the port" for name in allowed if name in port]
    for name, params in jax.items():
        if name in allowed:
            continue
        if name not in port:
            problems.append(f"{rel}: {name} has no counterpart in the port")
            continue
        if params is None or port[name] is None:
            continue
        drop = NO_PORT_PARAMS.get((rel, name), {})
        rename = RENAMES.get((rel, name), {})
        want = [rename.get(p, p) for p in params if p not in drop]
        got = [p for p in port[name] if p not in PORT_PARAMS or p in params]
        if got[: len(want)] != want:
            problems.append(f"{rel}: {name} takes {port[name]}, the JAX function {params}")
    return problems


@pytest.mark.parametrize("rel", _modules(JAX_PKG))
def test_port_has_the_jax_modules_surface(rel):
    problems = check_module(rel)
    assert not problems, "\n".join(problems)


def test_a_missing_method_is_named(tmp_path):
    """The check names what the port lacks: a copy of the port's polynomial
    module without ``Poly.scale`` fails on exactly that method."""
    rel = "poly/polynomial.py"
    with open(os.path.join(PORT_PKG, rel)) as f:
        tree = ast.parse(f.read())
    (poly,) = [n for n in tree.body if isinstance(n, ast.ClassDef) and n.name == "Poly"]
    poly.body = [n for n in poly.body if getattr(n, "name", None) != "scale"]
    (tmp_path / "poly").mkdir()
    (tmp_path / rel).write_text(ast.unparse(tree))
    assert check_module(rel, port_pkg=str(tmp_path)) == [
        f"{rel}: Poly.scale has no counterpart in the port"]
