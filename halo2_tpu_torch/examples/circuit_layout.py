"""circuit-layout.rs analog: render a circuit's region layout to SVG and its
namespace call tree to DOT (``examples/circuit_layout.py`` ported).

The tests/plonk_api.rs standard-plonk + lookup circuit at k=5, drawn by the
dependency-free renderers of ``dev/graph.py``.  Writes ``layout.svg`` and
``circuit.dot`` into ``out_dir`` (the working directory by default):

    python -m halo2_tpu_torch.examples.circuit_layout
"""

from __future__ import annotations

import os
import sys

from ..circuit import Value
from ..curves.spec import BN254_G1
from ..dev.graph import CircuitLayout, circuit_dot_graph

TESTS = os.path.join(os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(__file__)))),
                     "tests")


def main(out_dir: str = ".") -> tuple:
    """Write both files; return (svg, dot)."""
    sys.path.insert(0, TESTS)
    from torch_circuits import StandardPlonkCircuit, plonk_api_common

    spec = BN254_G1.scalar
    _, instance, table = plonk_api_common(spec)
    circuit = StandardPlonkCircuit(Value.unknown(), table)

    svg = CircuitLayout().render(spec, 5, circuit, [[instance]])
    dot = circuit_dot_graph(spec, circuit)
    for name, text in (("layout.svg", svg), ("circuit.dot", dot)):
        with open(os.path.join(out_dir, name), "w") as f:
            f.write(text)
        print(f"{name}: {len(text)} bytes")
    return svg, dot


if __name__ == "__main__":
    main()
