"""The graph container (≙ ``bigdl_tpu/nn/graph.py``): ``Node``,
``Input``, ``Module.inputs`` and ``Graph`` (``DynamicGraph``, and the
reference's aliases ``StaticGraph`` and ``Model``).

    inp = Input()
    h = Linear(10, 20).inputs(inp)
    out = ReLU().inputs(h)
    model = Graph(inp, out)

``Graph`` sorts the nodes topologically (depth first from the outputs,
as the reference does) and evaluates them in that order.  The nodes'
modules are registered as its children in that order (``"0"``, ``"1"``,
...), which is the reference's ``Graph.children()``: ``get_weights`` and
``models.convert.from_jax_weights`` walk them in it.  A node with several
inputs takes them as a list; several outputs come back as a list.
"""
from __future__ import annotations

from typing import List, Optional

from .module import Module


class Node:
    """A graph node: a module (None for an input) and the nodes that feed
    it (``module.inputs(...)`` makes one)."""

    def __init__(self, module: Optional[Module], prev_nodes: List["Node"]):
        self.module = module
        self.prev_nodes = list(prev_nodes)

    @property
    def name(self):
        return self.module.name if self.module else "input"

    def __repr__(self):
        return f"Node({self.name})"


def Input(name=None):                                    # noqa: N802
    """A placeholder node for one input of a graph."""
    return Node(None, [])


class Graph(Module):
    """A static DAG of modules from ``input`` node(s) to ``output``
    node(s)."""

    def __init__(self, input, output, name=None):
        super().__init__(name=name)
        self.input_nodes = list(input) if isinstance(input, (list, tuple)) \
            else [input]
        self.output_nodes = list(output) if isinstance(
            output, (list, tuple)) else [output]
        self.sort()

    def sort(self):
        """Sort the nodes again and register their modules as children in
        that order (after the graph's edges were rewired)."""
        self._topo = self._topsort()
        self._modules.clear()
        for i, m in enumerate(n.module for n in self._topo
                              if n.module is not None):
            self.add_module(str(i), m)

    def _topsort(self):
        order, seen, visiting = [], set(), set()

        def visit(n):
            if id(n) in seen:
                return
            if id(n) in visiting:
                raise ValueError("Graph contains a cycle")
            visiting.add(id(n))
            for p in n.prev_nodes:
                visit(p)
            visiting.discard(id(n))
            seen.add(id(n))
            order.append(n)

        for out in self.output_nodes:
            visit(out)
        return order

    def apply(self, params, x, ctx):
        xs = list(x) if isinstance(x, (list, tuple)) else [x]
        if len(xs) != len(self.input_nodes):
            if len(self.input_nodes) != 1:
                raise ValueError(f"Graph expects {len(self.input_nodes)} "
                                 f"inputs, got {len(xs)}")
            xs = [x]
        values = {id(n): v for n, v in zip(self.input_nodes, xs)}
        for node in self._topo:
            if id(node) in values:
                continue
            if node.module is None:
                raise ValueError("unbound Input node")
            ins = [values[id(p)] for p in node.prev_nodes]
            values[id(node)] = node.module.apply(
                params, ins[0] if len(ins) == 1 else ins, ctx)
        outs = [values[id(n)] for n in self.output_nodes]
        return outs[0] if len(outs) == 1 else outs

    def node(self, name):
        for n in self._topo:
            if n.module is not None and n.module.name == name:
                return n
        raise KeyError(name)


# the reference's DynamicGraph schedules nodes lazily for its control-flow
# ops; without those (ROADMAP A9) it is the same evaluation
DynamicGraph = Graph
