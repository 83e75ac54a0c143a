"""Circuit drawing (port of the DV part of qcpinn_tpu/utils/drawing.py; the
reference saves a circuit.pdf via qml.draw_mpl, nn/DVPDESolver.py:144-158):
a text diagram of the gate program, and a matplotlib rendering of the same
where matplotlib is installed, saved into the run directory. The CV
drawing waits for the CV solver (ROADMAP queue 1)."""

from __future__ import annotations

import os
from typing import List, Optional

from ..ops.circuit import DVCircuit
from ..ops.diag_fusion import DiagRun

_TWO_WIRE = ("cnot", "cz", "crx", "cry", "crz", "u2q", "swap")
_TARGET = {"cnot": "⊕", "cz": "Z", "crx": "RX", "cry": "RY", "crz": "RZ",
           "u2q": "U", "swap": "x"}
_ONE_WIRE = {"rx": "RX", "ry": "RY", "rz": "RZ", "rot": "R3", "ps": "P", "h": "H",
             "x": "X", "y": "Y", "z": "Z", "u1q": "U"}


def circuit_text(circuit: DVCircuit, fused: bool = False) -> str:
    """Wire-per-line ASCII diagram of one ansatz layer (+ epilogue)."""
    program = (circuit.program if fused else circuit.program_raw) + circuit.epilogue
    n = circuit.n
    lines: List[List[str]] = [[f"q{w:>2}:"] for w in range(n)]
    for op in program:
        cells = [""] * n
        if isinstance(op, DiagRun):
            cells = ["[D]"] * n
        elif op.kind in _TWO_WIRE:
            a, b = op.wires
            cells[a] = "●" if op.kind != "u2q" else "U"
            cells[b] = _TARGET[op.kind]
            for w in range(min(a, b) + 1, max(a, b)):
                cells[w] = "│"
        else:
            cells[op.wires[0]] = _ONE_WIRE[op.kind]
        width = max((len(c) for c in cells), default=1)
        for w in range(n):
            pad = cells[w] if cells[w] else "─" * width
            lines[w].append(f"─{pad:─^{width}}─")
    return "\n".join("".join(row) for row in lines)


def draw_circuit(
    circuit: DVCircuit, out_dir: Optional[str] = None, name: str = "circuit"
) -> str:
    """Write circuit.txt, and circuit.pdf when matplotlib is installed (as
    in the JAX package, its absence skips the PDF and nothing else).
    Returns the text diagram."""
    text = circuit_text(circuit)
    header = (
        f"ansatz={circuit.ansatz} n={circuit.n} layers={circuit.layers} "
        f"params/layer={circuit.params_per_layer} encoding={circuit.encoding}\n"
        f"(one layer shown; encoding RX/amplitude prep precedes it)\n\n"
    )
    if out_dir is not None:
        with open(os.path.join(out_dir, f"{name}.txt"), "w") as f:
            f.write(header + text + "\n")
        try:
            import matplotlib
        except ImportError:
            return header + text
        matplotlib.use("Agg")
        import matplotlib.pyplot as plt

        fig, ax = plt.subplots(
            figsize=(min(2 + 0.25 * len(circuit.program_raw), 40), 1 + 0.4 * circuit.n)
        )
        ax.axis("off")
        ax.text(0, 1, header + text, family="monospace", fontsize=7,
                va="top", transform=ax.transAxes)
        fig.savefig(os.path.join(out_dir, f"{name}.pdf"), bbox_inches="tight")
        plt.close(fig)
    return header + text
