"""aten-level graph tracer and pattern search
(``quantized_vit_tpu/graph/tracer.py``).

The JAX package traces with ``jax.make_jaxpr``; the port traces with
``torch.fx.experimental.proxy_tensor.make_fx``, its counterpart: one graph
of primitive (aten) ops, one placeholder per input leaf, each node's output
value in ``node.meta["val"]``. ``torch.fx.symbolic_trace`` would record
module calls, without shapes, and cannot see through
``torch.func.functional_call``; ``make_fx`` runs the function and records
every op it dispatches.

The nodes keep the JAX tracer's shape (op, inputs, param_names, shape,
positional operands, attrs), searched with the same ``a > b > c`` chain
language; ``op`` is aten's op name (``convolution``, ``mm``, ``addmm``,
``bmm``, ``add``, ``permute``, ``view``, ...), ``getitem`` for an element
of a tuple output (``max_pool2d_with_indices``'). The declarative node
groups in builders.py remain the source of truth for the families;
:func:`validate_node_groups` checks them against a trace.
"""

from __future__ import annotations

import dataclasses
import operator
from typing import Any, Dict, List, Optional, Sequence, Tuple

import torch


@dataclasses.dataclass
class TraceNode:
    """One aten op application."""

    id: str
    op: str                       # aten op name (mm, convolution, ...)
    inputs: Tuple[str, ...]       # producing node ids or param paths
    param_names: Tuple[str, ...]  # params tree paths consumed directly
    shape: Optional[Tuple[int, ...]] = None
    # positional tensor operands: producer node id / param path / "<arg>"
    # for an unlabeled input or a constant of the trace / None for a
    # Python number in a tensor position
    arg_ids: Tuple[Optional[str], ...] = ()
    # a convolution's groups, stride and transposed flag; the dims of a
    # permute or transpose, the dim of unsqueeze or select; the reduced dims and keepdim
    # of a reduction; getitem's index
    attrs: Optional[Dict[str, Any]] = None

    def __repr__(self):  # pragma: no cover - debugging aid
        return f"TraceNode({self.id}: {self.op} <- {list(self.inputs)})"


def _path_str(kp) -> str:
    return "/".join(str(getattr(k, "key", getattr(k, "idx", k)))
                    for k in kp)


def tree_paths(tree) -> List[str]:
    """The '/'-joined paths of a tree's leaves in the order
    ``torch.utils._pytree`` flattens it (the order of ``make_fx``'s
    placeholders)."""
    from torch.utils import _pytree

    flat, _ = _pytree.tree_flatten_with_path(tree)
    return [_path_str(kp) for kp, _ in flat]


def _val_shape(val) -> Optional[Tuple[int, ...]]:
    if isinstance(val, (tuple, list)):
        val = val[0] if val else None
    if isinstance(val, torch.Tensor):
        return tuple(int(s) for s in val.shape)
    return None


def _op_name(target) -> str:
    if target is operator.getitem:
        return "getitem"
    packet = getattr(target, "overloadpacket", None)
    if packet is not None:
        return packet.__name__
    return getattr(target, "__name__", str(target))


def _attrs(op: str, node) -> Optional[Dict[str, Any]]:
    args = node.args
    if op == "convolution":
        return {"stride": tuple(args[3]), "transposed": bool(args[6]),
                "groups": int(args[8])}
    if op == "permute":
        return {"dims": tuple(int(d) for d in args[1])}
    if op == "transpose":
        return {"dims": (int(args[1]), int(args[2]))}
    if op in ("unsqueeze", "select"):
        return {"dim": int(args[1])}
    if op in ("mean", "sum", "amax", "amin", "prod"):
        dims = args[1] if len(args) > 1 else node.kwargs.get("dim")
        keep = args[2] if len(args) > 2 else node.kwargs.get("keepdim",
                                                             False)
        return {"dims": None if dims is None else tuple(
            int(d) for d in (dims if isinstance(dims, (list, tuple))
                             else [dims])), "keepdim": bool(keep)}
    if op == "getitem":
        return {"index": args[1]}
    return None


class TracedGraph:
    """Dataflow DAG of aten ops from one ``make_fx`` trace."""

    def __init__(self, nodes: List[TraceNode],
                 output_ids: Optional[Sequence[str]] = None):
        self.nodes = nodes
        self.by_id = {n.id: n for n in nodes}
        # producers of the traced function's outputs
        self.output_ids: Tuple[str, ...] = tuple(output_ids or ())

    # -- construction -----------------------------------------------------

    @staticmethod
    def trace(fn, *example_args, params=None) -> "TracedGraph":
        """Trace ``fn(*example_args)``; if ``params`` (a tree) is the
        first argument, the graph's inputs from it are labeled with its
        '/'-joined paths."""
        from torch._guards import TracingContext, tracing
        from torch._subclasses.fake_tensor import FakeTensorMode
        from torch.fx.experimental.proxy_tensor import make_fx

        # make_fx records each real output's metadata as a fake tensor and,
        # with no fake mode in context, makes a new FakeTensorMode (and its
        # traceback) a node: one mode for the whole trace halves its time
        with tracing(TracingContext(FakeTensorMode(
                allow_fallback_kernels=True))):
            gm = make_fx(fn)(*example_args)
        labels: Dict[Any, str] = {}
        placeholders = [n for n in gm.graph.nodes if n.op == "placeholder"]
        if params is not None:
            for ph, path in zip(placeholders, tree_paths(params)):
                labels[ph] = path

        nodes: List[TraceNode] = []
        producer: Dict[Any, str] = {}

        def operand(a):
            if a in labels:
                return labels[a]
            if a in producer:
                return producer[a]
            return "<arg>"  # an unlabeled input or a constant

        outputs: List[str] = []
        for fx_node in gm.graph.nodes:
            if fx_node.op == "output":
                flat = []

                def collect(v):
                    if isinstance(v, (list, tuple)):
                        for u in v:
                            collect(u)
                    elif isinstance(v, dict):
                        for u in v.values():
                            collect(u)
                    elif isinstance(v, torch.fx.Node):
                        flat.append(v)

                collect(fx_node.args)
                outputs = [producer[v] for v in flat if v in producer]
                continue
            if fx_node.op != "call_function":
                continue
            op = _op_name(fx_node.target)
            schema = getattr(fx_node.target, "_schema", None)
            kinds = ([str(a.type) for a in schema.arguments]
                     if schema is not None else [])
            inputs: List[str] = []
            pnames: List[str] = []
            arg_ids: List[Optional[str]] = []
            for i, a in enumerate(fx_node.args):
                items = a if isinstance(a, (list, tuple)) else [a]
                for item in items:
                    if isinstance(item, torch.fx.Node):
                        ident = operand(item)
                        arg_ids.append(ident)
                        if item in labels:
                            pnames.append(ident)
                            inputs.append(ident)
                        elif item in producer:
                            inputs.append(ident)
                    elif (isinstance(item, (int, float, bool))
                          and i < len(kinds)
                          and kinds[i] in ("Tensor", "Scalar")):
                        arg_ids.append(None)  # a literal
            nid = str(len(nodes))
            nodes.append(TraceNode(
                nid, op, tuple(inputs), tuple(pnames),
                _val_shape(fx_node.meta.get("val")), tuple(arg_ids),
                _attrs(op, fx_node)))
            producer[fx_node] = nid
        return TracedGraph(nodes, output_ids=outputs)

    # -- queries -----------------------------------------------------------

    def ops(self) -> List[str]:
        return [n.op for n in self.nodes]

    def incoming(self, node: TraceNode) -> List[TraceNode]:
        return [self.by_id[i] for i in node.inputs if i in self.by_id]

    def search(self, pattern: str) -> List[List[TraceNode]]:
        """Op chains matching ``"a > b > c"``: consecutive ops connected by
        direct dataflow; ``*`` matches any single op, a name matches an op
        it starts. Returns each match as [node_a, ...]."""
        want = [p.strip() for p in pattern.split(">")]
        consumers: Dict[str, List[TraceNode]] = {}
        for n in self.nodes:
            for src in dict.fromkeys(n.inputs):
                consumers.setdefault(src, []).append(n)
        matches: List[List[TraceNode]] = []

        def extend(chain: List[TraceNode], k: int):
            if k == len(want):
                matches.append(list(chain))
                return
            for n in consumers.get(chain[-1].id, ()):
                if _op_match(n.op, want[k]):
                    chain.append(n)
                    extend(chain, k + 1)
                    chain.pop()

        for n in self.nodes:
            if _op_match(n.op, want[0]):
                extend([n], 1)
        return matches

    def params_used(self) -> List[str]:
        out: List[str] = []
        seen = set()
        for n in self.nodes:
            for p in n.param_names:
                if p not in seen:
                    seen.add(p)
                    out.append(p)
        return out


def _op_match(op: str, pat: str) -> bool:
    return pat == "*" or op == pat or op.startswith(pat)


def validate_node_groups(graph: TracedGraph, groups: Sequence[Any],
                         params=None) -> Dict[str, List[str]]:
    """Cross-check declared node groups against a traced program.

    Returns {"missing": [declared paths never consumed by the trace],
             "uncovered": [traced kernel paths not in any group]}: both
    empty means the declaration is consistent with the model."""
    traced = set(graph.params_used())
    declared = {e.path for g in groups for e in g.entries}
    missing = sorted(p for p in declared if p not in traced)
    uncovered = sorted(
        p for p in traced
        if p.endswith(("kernel", "embedding")) and p not in declared)
    return {"missing": missing, "uncovered": uncovered}
