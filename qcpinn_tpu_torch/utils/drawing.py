"""Circuit drawing (port of qcpinn_tpu/utils/drawing.py; the reference saves
a circuit.pdf via qml.draw_mpl, nn/DVPDESolver.py:144-158 and
nn/CVPDESolver.py:139-152): a text diagram of the DV gate program or of the
CV layer's program, and a matplotlib rendering of the same where
matplotlib is installed, saved into the run directory."""

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


def _op_label(op) -> str:
    """One op's label: a fused diagonal run by what it holds, a gate by its
    kind and parameter indices."""
    if isinstance(op, DiagRun):
        kinds = []
        if len(op.pidx):
            kinds.append(f"{len(op.pidx)}θ")
        if op.quad:
            kinds.append(f"{len(op.quad)}×CRZ/CZ-quad")
        if op.const_pairs:
            kinds.append(f"{len(op.const_pairs)}×CZ")
        return f"DiagRun({', '.join(kinds)})"
    if op.pidx:
        return f"{op.kind.upper()}(θ{list(op.pidx)})"
    return op.kind.upper()


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


def _write(text: str, out_dir: Optional[str], name: str, figsize, fontsize) -> None:
    """``name``.txt in ``out_dir``, and ``name``.pdf when matplotlib is
    installed (as in the JAX package, its absence skips the PDF and nothing
    else)."""
    if out_dir is None:
        return
    with open(os.path.join(out_dir, f"{name}.txt"), "w") as f:
        f.write(text + "\n")
    try:
        import matplotlib
    except ImportError:
        return
    matplotlib.use("Agg")
    import matplotlib.pyplot as plt

    fig, ax = plt.subplots(figsize=figsize)
    ax.axis("off")
    ax.text(0, 1, text, family="monospace", fontsize=fontsize, va="top",
            transform=ax.transAxes)
    fig.savefig(os.path.join(out_dir, f"{name}.pdf"), bbox_inches="tight")
    plt.close(fig)


def draw_circuit(
    circuit: DVCircuit, out_dir: Optional[str] = None, name: str = "circuit"
) -> str:
    """Write circuit.txt (+ circuit.pdf). Returns the text diagram."""
    text = circuit_text(circuit)
    header = (
        f"ansatz={circuit.ansatz} n={circuit.n} layers={circuit.layers} "
        f"params/layer={circuit.params_per_layer} encoding={circuit.encoding}\n"
        f"(one layer shown; encoding RX/amplitude prep precedes it)\n\n"
    )
    _write(header + text, out_dir, name,
           (min(2 + 0.25 * len(circuit.program_raw), 40), 1 + 0.4 * circuit.n), 7)
    return header + text


def cv_circuit_text(layer) -> str:
    """Text diagram of a CVLayer program (the reference draws its CV QNode
    via qml.draw_mpl in nn/CVPDESolver.py:139-152; here the program is
    static, so the diagram is built from the wiring directly)."""
    m = layer.m
    encoding = ("Displacement(s_i * x_i, phi_i) per mode (learnable)" if layer.variant == 3
                else "Displacement(x_i, 0) per mode")
    lines = [
        f"CV circuit: variant {layer.variant}, {m} qumodes, "
        f"{layer.layers} layers, cutoff {layer.d}",
        "",
        "encoding: " + encoding,
    ]
    bs = " ".join(f"BS(q{a},q{b})" for _, (a, b) in layer.placements) or "—"
    rot = " ".join(f"R(q{i})" for i in range(max(1, m - 1)))
    for l in range(layer.layers):
        lines.append(f"layer {l}:")
        lines.append(f"  U1: {bs} | {rot}")
        lines.append("  S(r,phi) on every mode")
        lines.append(f"  U2: {bs} | {rot}")
        extra = " CubicPhase" if layer.variant == 3 else ""
        lines.append(f"  D(r,phi) + Kerr{extra} on every mode")
        if layer.variant == 3:
            pairs = " ".join(f"CK(q{i},q{j})" for i in range(m) for j in range(i + 1, m))
            lines.append(f"  CrossKerr: {pairs}")
    lines.append("readout: " + ("<x_i>" if layer.variant == 2 else "<n_i>") + " per mode")
    return "\n".join(lines)


def draw_cv_circuit(layer, out_dir: Optional[str] = None, name: str = "circuit") -> str:
    """Write circuit.txt (+ circuit.pdf) for a CV solver's quantum layer,
    as CVPDESolver.draw_quantum_circuit (nn/CVPDESolver.py:139-152)."""
    text = cv_circuit_text(layer)
    _write(text, out_dir, name, (10, 1 + 0.3 * len(text.splitlines())), 8)
    return text
