"""Genotype visualization (graphviz).

The port's own copy of ``bmnas_tpu/visualize.py`` (framework-free).
Re-implementation of the reference's renderer
(``models/search/darts/visualize.py:5-202``, facade
``models/search/plot_genotype.py:13-21``): modality-labelled input-feature
clusters, one cluster per fusion step showing the inner DAG (X/Y inputs,
named inner fusion ops, Z output), and a final reduction-output node fed by
the concat states. Task switches the input labels (mmimdb -> Image/Text,
ego/nvgesture -> RGB/Depth, default -> Video/Skeleton).

Renders a PDF when the system `dot` binary is available; otherwise writes the
.dot source (so headless images still record the architecture per epoch).
"""
from __future__ import annotations

from typing import List


def _input_labels(task: str, num_input_nodes: int) -> List[str]:
    if task == "mmimdb":
        a = [f"Image_{i+1}" for i in range(4)]
        b = [f"Text_{i+1}" for i in range(2)]
    elif task in ("ego", "nvgesture"):
        a = [f"RGB_{i+1}" for i in range(4)]
        b = [f"Depth_{i+1}" for i in range(4)]
    else:
        a = [f"Video_{i+1}" for i in range(4)]
        b = [f"Skeleton_{i+1}" for i in range(4)]
    labels = a + b
    assert len(labels) == num_input_nodes, (
        f"task {task!r} expects {len(labels)} inputs, got {num_input_nodes}")
    return labels


def _plain_dot(genotype, filename: str, labels: List[str],
               num_keep_edges: int, node_steps: int,
               node_multiplier: int) -> None:
    """Write DOT source without the graphviz package: plain nodes/edges only
    (no cluster styling), so every epoch's architecture is still recorded."""
    steps = len(genotype.edges) // num_keep_edges
    node_names = list(labels) + [f"Z_C{i+1}" for i in range(steps)]
    lines = ["digraph genotype {", "  rankdir=LR;"]
    for i in range(steps):
        sg = genotype.steps[i]
        inner = [f"X_C{i+1}", f"Y_C{i+1}"]
        for j in range(node_steps):
            inner.append(f"C{i+1}_S{j+1}_{sg.inner_steps[j]}")
        for j in range(node_steps):
            lines.append(f'  "{inner[sg.inner_edges[2*j][1]]}" -> "{inner[2+j]}";')
            lines.append(f'  "{inner[sg.inner_edges[2*j+1][1]]}" -> "{inner[2+j]}";')
        for j in range(node_multiplier):
            lines.append(f'  "{inner[-(j+1)]}" -> "Z_C{i+1}";')
        lines.append(f'  "{node_names[genotype.edges[2*i][1]]}" -> "X_C{i+1}";')
        lines.append(f'  "{node_names[genotype.edges[2*i+1][1]]}" -> "Y_C{i+1}";')
    for i in genotype.concat:
        lines.append(f'  "{node_names[i]}" -> "Reduction_Output";')
    lines.append("}")
    with open(filename + ".dot", "w") as f:
        f.write("\n".join(lines) + "\n")


def plot_genotype(genotype, filename: str, *, task: str, num_input_nodes: int,
                  num_keep_edges: int, node_steps: int, node_multiplier: int,
                  fmt: str = "pdf") -> None:
    if genotype is None:
        return
    try:
        from graphviz import Digraph
    except ImportError:
        # graphviz *python package* missing: still record the architecture
        # as plain DOT text and say so (no silent plot loss)
        import logging
        logging.getLogger("bmnas_tpu_torch").info(
            "graphviz package not installed - wrote %s.dot instead of a "
            "rendered plot", filename)
        _plain_dot(genotype, filename, _input_labels(task, num_input_nodes),
                   num_keep_edges, node_steps, node_multiplier)
        return

    g = Digraph(
        format=fmt,
        edge_attr=dict(fontsize="20", fontname="times", penwidth="1.5"),
        node_attr=dict(style="rounded, filled", shape="rect", align="center",
                       fontsize="20", height="0.5", width="0.5", penwidth="2",
                       fontname="helvetica"),
        engine="dot",
    )
    g.attr(rankdir="LR")

    labels = _input_labels(task, num_input_nodes)
    n_a = 4
    with g.subgraph(name="cluster_modality_a", node_attr={"shape": "box"}) as ca:
        ca.attr(style="rounded, filled", color="lightgrey", fontsize="20")
        for name in labels[:n_a]:
            ca.node(name, fillcolor="lightskyblue1")
    with g.subgraph(name="cluster_modality_b", node_attr={"shape": "box"}) as cb:
        cb.attr(style="rounded, filled", color="lightgrey", fontsize="20")
        for name in labels[n_a:]:
            cb.node(name, fillcolor="darkolivegreen1")

    assert len(genotype.edges) % num_keep_edges == 0
    steps = len(genotype.edges) // num_keep_edges

    node_names = list(labels)
    for i in range(steps):
        node_names.append(f"Z_C{i+1}")

    for i in range(steps):
        step_gene = genotype.steps[i]
        node_x, node_y, node_z = f"X_C{i+1}", f"Y_C{i+1}", f"Z_C{i+1}"
        with g.subgraph(name=f"cluster_step_{i}", node_attr={"shape": "box"}) as c:
            c.attr(style="rounded, filled", color="tan1", fontsize="20")
            inner = [node_x, node_y]
            for j in range(node_steps):
                inner.append(f"C{i+1}_S{j+1}\n{step_gene.inner_steps[j]}")
                c.node(inner[-1], fillcolor="khaki1")
            c.node(node_x, fillcolor="maroon2")
            c.node(node_y, fillcolor="green3")
            c.node(node_z, fillcolor="purple")
            for j in range(node_steps):
                c.edge(inner[step_gene.inner_edges[2 * j][1]], inner[2 + j])
                c.edge(inner[step_gene.inner_edges[2 * j + 1][1]], inner[2 + j])
            for j in range(node_multiplier):
                c.edge(inner[-(j + 1)], node_z)

        g.edge(node_names[genotype.edges[2 * i][1]], node_x, color="blue")
        g.edge(node_names[genotype.edges[2 * i + 1][1]], node_y, color="blue")

    g.node("Reduction\nOutput", fillcolor="grey91")
    for i in genotype.concat:
        g.edge(node_names[i], "Reduction\nOutput", color="blue")

    try:
        g.render(filename, view=False, cleanup=True)
    except Exception:
        # no system `dot`: keep the source so the architecture is recorded
        with open(filename + ".dot", "w") as f:
            f.write(g.source)


class Plotter:
    """Facade matching the reference Plotter (plot_genotype.py:13-21)."""

    def __init__(self, args):
        self.args = args

    def plot(self, genotype, filename: str, task: str = None) -> None:
        plot_genotype(
            genotype, filename, task=task,
            num_input_nodes=self.args.num_input_nodes,
            num_keep_edges=self.args.num_keep_edges,
            node_steps=self.args.node_steps,
            node_multiplier=self.args.node_multiplier,
        )
