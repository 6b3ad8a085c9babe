"""Automatic pruning-dependency discovery from an aten trace
(``quantized_vit_tpu/graph/autogroups.py``).

The reference partitions arbitrary models into pruning-zero-invariant
groups ("pzigs") by walking its traced ONNX graph
(dependency_graph/pruning_dependency.py:347-538): connected components of
non-stem nodes grow upstream until stem nodes (steps 1-3), intersecting
groups merge (step 4, residual additions), depthwise convs merge into
their incoming group (step 7), and groups adjacent to the model output are
unprunable (step 10). Composed ops (attention) are not discovered; they
come from the declarative builders (builders.py).

This module runs the same steps on the
:class:`~quantized_vit_tpu_torch.graph.tracer.TracedGraph` of
``models.apply_variables``, for basic architectures (convnets with
BN/residuals/depthwise, MLPs):

1. every ``mm``/``bmm``/``addmm``/``convolution`` whose weight operand
   derives from a single labeled kernel (through the quantizer's forward,
   a ``permute`` or a ``view``) is a **stem**; its out-channels are a
   candidate pruning group. A convolution's output is NCHW (the port's
   convs permute NHWC to NCHW and back), so its channel axis is 1; a
   dense product's is its last.
2. walk the dataflow forward from each stem, tracking which axis of each
   value carries the stem's channels: elementwise ops keep it, ``permute``
   moves it exactly, reductions over other axes shift it, reshapes keep it
   while the trailing dim is kept (or fold leading positions into it: a
   flatten).
3. where two tracked flows meet at an elementwise op (a residual add),
   their stems merge into one group (union-find, reference step 4).
4. a (C,)-shaped param on the untracked side of an elementwise op (BN/LN
   scale and bias, through their rsqrt math) joins the group as an
   ACCESSORY.
5. a tracked value feeding another stem stops there (that stem's in-dim
   follows at compression); feeding a DEPTHWISE conv (``groups > 1`` with
   an HWIO kernel [k, k, 1, C]) merges its kernel into the group and
   continues through it (reference step 7).
6. a tracked value reaching the traced output, or an op the walk cannot
   see through, makes the group unprunable (reference step 10,
   conservatively extended): an unknown op is opaque, never wrong.

BatchNorm statistics passed through ``apply_variables`` are constants of
the trace; only the params are its labeled inputs.
"""

from __future__ import annotations

import dataclasses
import math
from typing import Any, Dict, List, Optional, Set, Tuple

import numpy as np

from ..models.layers import (QUANT_PARAM_NAMES, apply_variables,
                             flatten_tree)
from ..opt.groups import NodeGroup, ParamEntry, Transform
from .tracer import TracedGraph, TraceNode

# ops through which the channel axis passes unchanged (elementwise, shape-
# preserving); binary members may also merge flows or pick up accessories
_ELEMENTWISE = {
    "add", "sub", "rsub", "mul", "div", "maximum", "minimum", "pow",
    "bitwise_and", "bitwise_or", "bitwise_xor", "logical_and", "logical_or",
    "logical_not", "tanh", "sigmoid", "exp", "log", "rsqrt", "sqrt", "erf",
    "erfc", "abs", "sign", "neg", "reciprocal", "floor", "ceil", "round",
    "trunc", "clamp", "clamp_min", "clamp_max", "hardtanh", "where",
    "masked_fill", "relu", "gelu", "silu", "leaky_relu", "_to_copy",
    "detach", "clone", "alias", "copy", "scalar_tensor",
    "eq", "ne", "lt", "le", "gt", "ge", "nan_to_num",
}
# ops that keep the rank and the channel axis (pooling and padding over
# the spatial axes, slicing, an element of a tuple output)
_PASS_THROUGH = {
    "max_pool2d_with_indices", "max_pool2d", "avg_pool2d",
    "constant_pad_nd", "slice", "flip", "getitem",
}
_REDUCTIONS = {"mean", "sum", "amax", "amin", "prod"}
_RESHAPES = {"view", "_unsafe_view", "reshape"}
_STEM_OPS = {"mm", "bmm", "addmm", "convolution"}
# the JAX walk's opaque ops (concatenate, gather, scatter, sort, argmax):
# opaque here too, even where the default rule below would follow them
_OPAQUE = {"cat", "stack", "index", "gather", "scatter", "index_select",
           "sort", "argmax", "argmin", "split", "split_with_sizes",
           "unbind"}


@dataclasses.dataclass
class _Stem:
    node: TraceNode
    kernel_path: str
    bias_path: Optional[str]
    out_channels: int
    depthwise: bool


class _UnionFind:
    def __init__(self, n: int):
        self.p = list(range(n))

    def find(self, a: int) -> int:
        while self.p[a] != a:
            self.p[a] = self.p[self.p[a]]
            a = self.p[a]
        return a

    def union(self, a: int, b: int):
        ra, rb = self.find(a), self.find(b)
        if ra != rb:
            self.p[max(ra, rb)] = min(ra, rb)


def _param_shapes(params) -> Dict[str, Tuple[int, ...]]:
    return {k: tuple(np.shape(v)) for k, v in flatten_tree(params).items()}


def _layer_of(path: str) -> str:
    return path.rsplit("/", 1)[0] if "/" in path else path


def _is_quant_scalar(path: str) -> bool:
    """Quant scalars never prune and never count as accessories."""
    return path.rsplit("/", 1)[-1] in QUANT_PARAM_NAMES


def _build_provenance(graph: TracedGraph) -> Dict[str, Set[str]]:
    """Transitive labeled-param set per node (nodes are topological)."""
    provenance: Dict[str, Set[str]] = {}
    for n in graph.nodes:
        deps: Set[str] = set(n.param_names)
        for src in n.inputs:
            if src in provenance:
                deps |= provenance[src]
        provenance[n.id] = deps
    return provenance


def _operand_kernel(arg_id, shapes, provenance) -> Optional[str]:
    """The >=2-dim labeled param an operand (transitively) derives from:
    found through the quantizer's forward, a ``permute`` or a ``view``;
    None when the operand is not a single kernel's product."""
    if arg_id is None or arg_id == "<arg>":
        return None
    deps = {arg_id} if arg_id in shapes else provenance.get(arg_id, set())
    kernels = [p for p in deps if len(shapes.get(p, ())) >= 2
               and not _is_quant_scalar(p)]
    return kernels[0] if len(kernels) == 1 else None


def _stem_kernel(n: TraceNode, shapes, provenance) -> Optional[str]:
    """The kernel of a product node: a convolution's weight operand; a
    dense product's right operand, else its left (``addmm``'s operands
    follow its bias)."""
    args = n.arg_ids[1:] if n.op == "addmm" else n.arg_ids
    if len(args) < 2:
        return None
    if n.op == "convolution":
        return _operand_kernel(args[1], shapes, provenance)
    return (_operand_kernel(args[1], shapes, provenance)
            or _operand_kernel(args[0], shapes, provenance))


def _channel_axis(node: TraceNode) -> int:
    """The axis of a stem's output that carries its out-channels."""
    return 1 if node.op == "convolution" else len(node.shape or ()) - 1


@dataclasses.dataclass
class StemPlan:
    """Per-stem compression recipe (generic subnet construction): which
    group owns the stem's out-dim, which group's kept indices its in-dim
    follows, and the flatten multiplicity (spatial positions folded into
    the feature axis between the producer and this stem), as the
    reference's ``automated_pruning_compression`` derives them by DFS
    (pruning_compression.py:134-215, 335-346)."""

    kernel_path: str
    bias_path: Optional[str]
    group_id: str                     # group owning the out-dim
    op: str                           # the product's aten op: mm, convolution
    depthwise: bool
    in_group_id: Optional[str] = None  # group whose kept idxes the in-dim follows
    in_spatial: int = 1               # flatten expansion factor
    in_channels: int = 0              # producer group's channel count


def trace_apply(model, params, example_input, batch_stats=None,
                model_kwargs: Optional[dict] = None) -> TracedGraph:
    """The :class:`TracedGraph` of ``models.apply_variables(model, params,
    example_input, batch_stats=..., **model_kwargs)``, its inputs labeled
    with the params tree's paths: the trace :func:`discover_node_groups`
    and :func:`trace_cost_report` walk."""
    kw = dict(model_kwargs or {})

    def fn(params_arg, x):
        return apply_variables(model, params_arg, x,
                               batch_stats=batch_stats, **kw)

    return TracedGraph.trace(fn, params, example_input, params=params)


def discover_node_groups(model, params, example_input,
                         batch_stats=None,
                         model_kwargs: Optional[dict] = None,
                         return_edges: bool = False,
                         return_plan: bool = False,
                         graph: Optional[TracedGraph] = None):
    """Partition a basic model into pruning groups by aten dataflow.

    Traces ``models.apply_variables(model, params, example_input,
    batch_stats=..., **model_kwargs)`` and runs the steps of the module
    docstring. Returns NodeGroups for GETA/HESSO/compression; raises
    ValueError when the trace holds no stem.

    ``return_edges``: also return the sorted (producer group, consumer
    group) data dependencies. ``return_plan``: also return ``{kernel_path:
    StemPlan}``, the in-dim links of generic physical compression
    (compress/auto.py). ``graph``: :func:`trace_apply` of these same
    arguments (the same ``params`` above all), made before, walked instead
    of tracing again; nothing checks that it matches them."""
    if graph is None:
        graph = trace_apply(model, params, example_input, batch_stats,
                            model_kwargs)
    shapes = _param_shapes(params)

    consumers: Dict[str, List[TraceNode]] = {}
    for n in graph.nodes:
        for src in n.inputs:
            consumers.setdefault(src, []).append(n)
    output_ids = set(graph.output_ids)
    provenance = _build_provenance(graph)

    # ------------------------------------------------------------------
    # step 1: stems, their kernels found by provenance
    # ------------------------------------------------------------------
    stems: List[_Stem] = []
    stem_by_node: Dict[str, int] = {}
    grouped_conv_stems: Set[int] = set()
    for n in graph.nodes:
        if n.op not in _STEM_OPS:
            continue
        kpath = _stem_kernel(n, shapes, provenance)
        if kpath is None:
            continue
        kshape = shapes[kpath]
        out_ch = kshape[-1]
        # depthwise iff the conv says so (groups > 1 with one in-channel a
        # filter); a regular conv on 1-channel input also has kshape[2] ==
        # 1 but groups == 1 and forms its own group like any other stem
        groups = int(n.attrs.get("groups", 1)) if n.attrs else 1
        depthwise = (n.op == "convolution" and groups > 1
                     and len(kshape) == 4 and kshape[2] == 1)
        if n.op == "convolution" and groups > 1 and not depthwise:
            # a general grouped conv: a channel<->group coupling this
            # partitioner does not model; the stem stays, never pruned
            grouped_conv_stems.add(len(stems))
        bias = None
        cand = f"{_layer_of(kpath)}/bias"
        if cand in shapes and shapes[cand] == (out_ch,):
            bias = cand
        stem_by_node[n.id] = len(stems)
        stems.append(_Stem(n, kpath, bias, out_ch, depthwise))

    if not stems:
        raise ValueError("no kernel-consuming stems found in trace")

    uf = _UnionFind(len(stems))
    accessories: Dict[int, List[str]] = {i: [] for i in range(len(stems))}
    # unprunable holds STEM indices, not union-find roots: a later merge
    # re-roots the group, and a root recorded at marking time would drop
    # the flag; the assembly checks members against it
    unprunable: Set[int] = set(grouped_conv_stems)
    stem_edges: Set[Tuple[int, int]] = set()
    in_links: Dict[int, Set[Tuple[int, int]]] = {}
    claimed: Dict[Tuple[str, int], int] = {}

    # ------------------------------------------------------------------
    # steps 2-7: forward walk from each stem
    # ------------------------------------------------------------------
    def walk(stem_idx: int):
        stem = stems[stem_idx]
        start = stem.node
        # (node_id, channel_axis, spatial) frontier; the axis indexes the
        # node's OUTPUT; spatial counts positions folded into the axis by
        # flattens (pruning_compression.py:335-346)
        ax0 = _channel_axis(start)
        frontier: List[Tuple[str, int, int]] = [(start.id, ax0, 1)]
        seen: Set[Tuple[str, int]] = {(start.id, ax0)}

        while frontier:
            nid, axis, spatial = frontier.pop()
            if nid in output_ids:
                unprunable.add(stem_idx)
            for nxt in consumers.get(nid, ()):
                if nxt.op in _STEM_OPS and nxt.id in stem_by_node:
                    j = stem_by_node[nxt.id]
                    stem_edges.add((stem_idx, j))
                    # a product's data input: its in-dim follows at
                    # compression
                    in_links.setdefault(j, set()).add((stem_idx, spatial))
                    if stems[j].depthwise:
                        # step 7: the depthwise conv joins the group
                        uf.union(stem_idx, j)
                        key = (nxt.id, _channel_axis(nxt))
                        if key not in seen:
                            seen.add(key)
                            frontier.append((nxt.id, key[1], spatial))
                    continue
                stepped = _axis_through(nxt, nid, axis, graph)
                if stepped is None:
                    # an opaque op next to the group: unprunable
                    unprunable.add(stem_idx)
                    continue
                new_axis, mult = stepped
                new_spatial = spatial * mult
                if nxt.op in _ELEMENTWISE and len(nxt.inputs) > 1:
                    for other in nxt.inputs:
                        if other == nid:
                            continue
                        key = (other, axis)
                        if key in claimed and \
                                uf.find(claimed[key]) != uf.find(stem_idx):
                            # step 4: a residual junction merges groups
                            uf.union(claimed[key], stem_idx)
                        else:
                            # accessory params reaching this op (BN/LN
                            # scale/bias). The other operand must be a PURE
                            # per-channel chain: a kernel in its provenance
                            # makes it a data branch, never an accessory
                            deps = (provenance.get(other, set())
                                    if other in graph.by_id
                                    else ({other} if other in shapes
                                          else set()))
                            if any(len(shapes.get(q, ())) >= 2
                                   for q in deps):
                                continue
                            for p in deps:
                                if (shapes.get(p) == (stem.out_channels,)
                                        and not _is_quant_scalar(p)
                                        and p not in accessories[stem_idx]):
                                    accessories[stem_idx].append(p)
                key = (nxt.id, new_axis)
                claimed[key] = stem_idx
                if key not in seen:
                    seen.add(key)
                    frontier.append((nxt.id, new_axis, new_spatial))

    for i, s in enumerate(stems):
        if not s.depthwise:
            claimed[(s.node.id, _channel_axis(s.node))] = i
    for i, s in enumerate(stems):
        if not s.depthwise:
            walk(i)

    # ------------------------------------------------------------------
    # assemble groups per union-find root
    # ------------------------------------------------------------------
    roots: Dict[int, List[int]] = {}
    for i in range(len(stems)):
        roots.setdefault(uf.find(i), []).append(i)

    groups: List[NodeGroup] = []
    for root, members in sorted(roots.items()):
        out_ch = stems[members[0]].out_channels
        entries: List[ParamEntry] = []
        added: Set[str] = set()
        ok = True
        for i in members:
            s = stems[i]
            if s.out_channels != out_ch:
                ok = False  # an inconsistent merge
            for path, tf in ((s.kernel_path, Transform.OUT),
                             (s.bias_path, Transform.ACCESSORY)):
                if path and path not in added:
                    added.add(path)
                    entries.append(ParamEntry(path, tf))
            layer = _layer_of(s.kernel_path)
            for q in QUANT_PARAM_NAMES:
                qp = f"{layer}/{q}"
                if qp in shapes and qp not in added:
                    added.add(qp)
                    entries.append(ParamEntry(qp, Transform.NO_PRUNE))
            for p in accessories.get(i, ()):
                if p not in added:
                    added.add(p)
                    entries.append(ParamEntry(p, Transform.ACCESSORY))
        groups.append(NodeGroup(
            id=_layer_of(stems[members[0]].kernel_path), entries=entries,
            num_groups=out_ch,
            is_prunable=ok and not any(i in unprunable for i in members)))
    gid_of = {root: _layer_of(stems[members[0]].kernel_path)
              for root, members in roots.items()}
    ret: List[Any] = [groups]
    if return_edges:
        ret.append(sorted({
            (gid_of[uf.find(a)], gid_of[uf.find(b)])
            for a, b in stem_edges if uf.find(a) != uf.find(b)}))
    if return_plan:
        plan: Dict[str, StemPlan] = {}
        for j, s in enumerate(stems):
            sp = StemPlan(
                kernel_path=s.kernel_path, bias_path=s.bias_path,
                group_id=gid_of[uf.find(j)], op=s.node.op,
                depthwise=s.depthwise)
            feeds = in_links.get(j, set())
            feed_roots = {uf.find(i) for i, _ in feeds}
            spatials = {sp_ for _, sp_ in feeds}
            if len(feed_roots) == 1 and len(spatials) == 1:
                r = feed_roots.pop()
                sp.in_group_id = gid_of[r]
                sp.in_spatial = spatials.pop()
                sp.in_channels = stems[roots[r][0]].out_channels
            # an ambiguous in-feed (a concat of groups) leaves the in-dim
            # unlinked; construct_subnet_auto skips it
            plan[s.kernel_path] = sp
        ret.append(plan)
    return ret[0] if len(ret) == 1 else tuple(ret)


def trace_cost_report(model, params, example_input,
                      batch_stats=None,
                      model_kwargs: Optional[dict] = None) -> Dict[str, Any]:
    """Analytic cost report from the trace, for any model: per stem, MACs
    = prod(out_shape) * prod(kernel_shape[:-1]) / batch (independent of
    the output's layout), BOPs = MACs * w_bit * a_bit from the layer's
    learned quant scalars (32 where absent); ``total_macs`` is per example
    (divided by the input's leading dim)."""
    from .costs import _layer_bits

    graph = trace_apply(model, params, example_input, batch_stats,
                        model_kwargs)
    shapes = _param_shapes(params)
    batch = int(np.shape(example_input)[0]) or 1
    provenance = _build_provenance(graph)

    report: Dict[str, Any] = {"per_layer": {}, "total_macs": 0.0,
                              "total_bops": 0.0}
    for n in graph.nodes:
        if n.op not in _STEM_OPS:
            continue
        kpath = _stem_kernel(n, shapes, provenance)
        if kpath is None or n.shape is None:
            continue
        contraction = int(np.prod(shapes[kpath][:-1]))
        macs = float(np.prod(n.shape)) * contraction / batch
        layer = _layer_of(kpath)
        w_bit, a_bit = _layer_bits(params, layer)
        entry = report["per_layer"].setdefault(
            layer, {"macs": 0.0, "bops": 0.0, "w_bit": w_bit,
                    "a_bit": a_bit})
        entry["macs"] += macs
        entry["bops"] += macs * w_bit * a_bit
        report["total_macs"] += macs
        report["total_bops"] += macs * w_bit * a_bit
    report["num_params"] = int(sum(
        math.prod(s) for p, s in shapes.items() if not _is_quant_scalar(p)))
    return report


def _axis_through(node: TraceNode, src_id: str, axis: int,
                  graph: TracedGraph) -> Optional[Tuple[int, int]]:
    """Where does ``axis`` of input ``src_id`` land in ``node``'s output?

    Returns (new_axis, spatial_mult): spatial_mult > 1 where the op folds
    leading positions into the channel axis (a flatten: [B, H, W, C] ->
    [B, H*W*C], channels fastest-varying), the case the reference expands
    at pruning_compression.py:335-346. None: the walk cannot follow.
    """
    src_shape = graph.by_id[src_id].shape if src_id in graph.by_id else None
    out_shape = node.shape
    op = node.op
    if op in _ELEMENTWISE or op in _PASS_THROUGH:
        if (src_shape is not None and out_shape is not None
                and len(out_shape) == len(src_shape)):
            return axis, 1
        # a broadcasting binary op: align trailing axes
        if src_shape is not None and out_shape is not None:
            shift = len(out_shape) - len(src_shape)
            return (axis + shift, 1) if axis + shift >= 0 else None
        return axis, 1
    if op == "permute":
        dims = [d % len(src_shape) for d in node.attrs["dims"]]
        return dims.index(axis), 1
    if op in ("t", "transpose"):
        if op == "t":
            d0, d1 = 0, 1
        else:
            d0, d1 = (d % len(src_shape) for d in node.attrs["dims"])
        return (d1 if axis == d0 else d0 if axis == d1 else axis), 1
    if op == "unsqueeze":
        dim = node.attrs["dim"] % len(out_shape)
        return (axis + 1 if dim <= axis else axis), 1
    if op == "expand":  # prepends dims and widens size-1 ones
        return axis + len(out_shape) - len(src_shape), 1
    if op == "select":  # one index of a non-channel axis drops that axis
        dim = node.attrs["dim"] % len(src_shape)
        if dim == axis:
            return None
        return (axis - 1 if dim < axis else axis), 1
    if op in _REDUCTIONS:
        attrs = node.attrs or {}
        dims = attrs.get("dims")
        if dims is None or src_shape is None:
            return None
        dims = {d % len(src_shape) for d in dims}
        if axis in dims:
            return None
        if attrs.get("keepdim"):
            return axis, 1
        return axis - sum(1 for d in dims if d < axis), 1
    if op in _RESHAPES:
        if (src_shape and out_shape and src_shape[-1] == out_shape[-1]
                and axis == len(src_shape) - 1):
            return len(out_shape) - 1, 1
        # a flatten: the trailing dims (the tracked channel axis among
        # them) collapse into one feature axis, channels fastest-varying
        if (src_shape and out_shape and axis == len(src_shape) - 1
                and len(out_shape) < len(src_shape)
                and out_shape[-1] != src_shape[-1]
                and src_shape[-1] > 0
                and out_shape[-1] % src_shape[-1] == 0):
            folded = out_shape[-1] // src_shape[-1]
            lead = 1
            for k in range(len(src_shape) - 2, len(out_shape) - 2, -1):
                lead *= src_shape[k]
            if lead == folded:
                return len(out_shape) - 1, folded
        return None
    if op == "squeeze":
        if (src_shape and out_shape and axis == len(src_shape) - 1
                and out_shape[-1] == src_shape[-1]):
            return len(out_shape) - 1, 1
        return None
    if op in _OPAQUE:
        return None
    # default: same-rank ops keep the axis; rank changes are opaque
    if (src_shape is not None and out_shape is not None
            and len(out_shape) == len(src_shape)
            and out_shape[axis] == src_shape[axis]):
        return axis, 1
    return None
