"""Layer-graph extraction: model configs -> a DAG of CIM workload nodes.

Every schedulable unit (a conv layer or a CIM-mapped LM projection) becomes
a :class:`LayerNode` wrapping the ``perf_model.ConvLayer`` workload view
(a matmul over T tokens is a 1x1 conv with a 1 x T output plane). Edges are
data dependencies; the simulator consumes nodes in topological order and
uses edges to decide when a layer's activations exist.

Extractors:
  * ``graph_from_layers``  - linear chain from a perf-model layer table
    (used to cross-validate the simulator against ``summarize``).
  * ``vgg16_graph`` / ``resnet18_graph`` - the paper's CIFAR networks;
    ResNet18 is a real DAG (residual skips + 1x1 downsample convs).
  * ``lm_graph`` - CIM-mapped projections of a transformer ``ModelConfig``
    (QKV/O + MLP per block) as matmul nodes over a token batch.

Nodes may carry an actual 2-D weight (``kh*kw*cin x cout``); the allocator
then counts surviving group-sets exactly instead of using the layer's
``sparsity_gs`` profile.
"""
from __future__ import annotations

import dataclasses
from typing import Dict, Iterable, List, Optional, Sequence, Tuple

import numpy as np

from ..core import perf_model as PM
from ..core.perf_model import ConvLayer


@dataclasses.dataclass
class LayerNode:
    """One schedulable workload node in the layer DAG."""

    name: str
    layer: ConvLayer
    deps: Tuple[str, ...] = ()
    kind: str = "conv"  # conv | matmul
    weight: Optional[np.ndarray] = None  # optional (kh*kw*cin, cout) weight

    def kernel_group_counts(self, group: int, alpha: int,
                            dense: bool = False) -> np.ndarray:
        """Nonzero group-sets per kernel-group (output-group) column.

        The allocator balances these counts across cores. With a real
        weight attached the count is exact; otherwise the layer's
        ``sparsity_gs`` profile is spread evenly over the columns.
        """
        l = self.layer
        go = -(-l.cout // alpha)
        wg = l.kh * l.kw * -(-l.cin // group)
        if dense:
            return np.full(go, wg, dtype=np.int64)
        if self.weight is not None:
            return _exact_counts(self.weight, group, alpha)
        nnz = l.nnz_for(group, alpha)
        counts = np.full(go, nnz // go, dtype=np.int64)
        counts[: nnz % go] += 1
        return np.minimum(counts, wg)


def _exact_counts(w2d: np.ndarray, group: int, alpha: int) -> np.ndarray:
    d_in, d_out = w2d.shape
    gi, go = -(-d_in // group), -(-d_out // alpha)
    wp = np.zeros((gi * group, go * alpha), dtype=w2d.dtype)
    wp[:d_in, :d_out] = w2d
    tiles = wp.reshape(gi, group, go, alpha)
    alive = np.any(tiles != 0, axis=(1, 3))  # (gi, go)
    return alive.sum(axis=0).astype(np.int64)


@dataclasses.dataclass
class LayerGraph:
    nodes: Dict[str, LayerNode]

    def __post_init__(self) -> None:
        for n in self.nodes.values():
            for d in n.deps:
                if d not in self.nodes:
                    raise ValueError(f"{n.name} depends on unknown node {d}")

    def topo_order(self) -> List[str]:
        """Kahn topological order (raises on cycles)."""
        indeg = {k: len(v.deps) for k, v in self.nodes.items()}
        succs: Dict[str, List[str]] = {k: [] for k in self.nodes}
        for k, v in self.nodes.items():
            for d in v.deps:
                succs[d].append(k)
        ready = [k for k, d in indeg.items() if d == 0]
        out: List[str] = []
        while ready:
            k = ready.pop(0)
            out.append(k)
            for s in succs[k]:
                indeg[s] -= 1
                if indeg[s] == 0:
                    ready.append(s)
        if len(out) != len(self.nodes):
            raise ValueError("layer graph has a cycle")
        return out

    def layers(self) -> List[ConvLayer]:
        """Workload views in topological order (perf-model compatible)."""
        return [self.nodes[k].layer for k in self.topo_order()]

    @property
    def total_macs(self) -> int:
        return sum(n.layer.macs for n in self.nodes.values())


def graph_from_layers(layers: Sequence[ConvLayer],
                      names: Optional[Sequence[str]] = None) -> LayerGraph:
    """Linear chain over a perf-model layer table."""
    nodes: Dict[str, LayerNode] = {}
    prev: Tuple[str, ...] = ()
    for i, l in enumerate(layers):
        name = names[i] if names else f"L{i}_{l.kh}x{l.kw}x{l.cin}x{l.cout}"
        nodes[name] = LayerNode(name, l, deps=prev)
        prev = (name,)
    return LayerGraph(nodes)


def vgg16_graph(sparsity_per_layer: Optional[Sequence[float]] = None) -> LayerGraph:
    """VGG16-CIFAR chain with the paper's Table IV sparsity profile."""
    return graph_from_layers(PM.vgg16_cifar_layers(sparsity_per_layer))


def resnet18_graph(sparsity_per_layer: Optional[Sequence[float]] = None) -> LayerGraph:
    """ResNet18-CIFAR as a true DAG: stem, 8 residual blocks with skip
    edges, and the three 1x1 downsample convs the chain table omits.

    The residual add happens in the APW block, so a block's consumers
    simply depend on every producer of the stream (conv2 + the skip path).
    """
    chain = PM.resnet18_cifar_layers(sparsity_per_layer)
    stem, convs = chain[0], chain[1:]
    nodes: Dict[str, LayerNode] = {"stem": LayerNode("stem", stem)}
    prev: Tuple[str, ...] = ("stem",)  # producers of the residual stream
    ci = 0
    stages = [(64, 2, 1), (128, 2, 2), (256, 2, 2), (512, 2, 2)]
    cin = 64
    for si, (width, nblocks, stride) in enumerate(stages):
        for b in range(nblocks):
            c1, c2 = convs[ci], convs[ci + 1]
            n1, n2 = f"s{si}b{b}_conv1", f"s{si}b{b}_conv2"
            nodes[n1] = LayerNode(n1, c1, deps=prev)
            nodes[n2] = LayerNode(n2, c2, deps=(n1,))
            producers = [n2]
            if b == 0 and (stride != 1 or cin != width):
                nd = f"s{si}b{b}_down"
                down = ConvLayer(1, 1, cin, width, c2.out_h, c2.out_w,
                                 c2.sparsity_gs)
                nodes[nd] = LayerNode(nd, down, deps=prev)
                producers.append(nd)
            else:
                producers.extend(prev)  # identity skip feeds the add too
            prev = tuple(dict.fromkeys(producers))
            ci += 2
            cin = width
    return LayerGraph(nodes)


def lm_graph(cfg, seq_len: int = 512, sparsity_gs: float = 0.75,
             n_layers: Optional[int] = None) -> LayerGraph:
    """CIM-mapped projections of a transformer block stack.

    Each projection is a matmul node computing (seq_len, d_in) @ (d_in,
    d_out) - i.e. a 1x1 conv with a 1 x seq_len output plane. Attention
    math itself (softmax, RoPE) stays on the digital side and is not a CIM
    workload; QKV/O and the MLP projections are.
    """
    d = cfg.d_model
    hd = cfg.head_dim or d // cfg.n_heads
    dq, dkv = cfg.n_heads * hd, cfg.n_kv_heads * hd
    L = cfg.n_layers if n_layers is None else min(n_layers, cfg.n_layers)

    def mm(cin: int, cout: int) -> ConvLayer:
        return ConvLayer(1, 1, cin, cout, 1, seq_len, sparsity_gs)

    nodes: Dict[str, LayerNode] = {}
    prev: Tuple[str, ...] = ()
    for i in range(L):
        q, k, v = f"blk{i}_wq", f"blk{i}_wk", f"blk{i}_wv"
        o, up, gate, down = (f"blk{i}_wo", f"blk{i}_w_up",
                             f"blk{i}_w_gate", f"blk{i}_w_down")
        nodes[q] = LayerNode(q, mm(d, dq), deps=prev, kind="matmul")
        nodes[k] = LayerNode(k, mm(d, dkv), deps=prev, kind="matmul")
        nodes[v] = LayerNode(v, mm(d, dkv), deps=prev, kind="matmul")
        nodes[o] = LayerNode(o, mm(dq, d), deps=(q, k, v), kind="matmul")
        nodes[up] = LayerNode(up, mm(d, cfg.d_ff), deps=(o,), kind="matmul")
        nodes[gate] = LayerNode(gate, mm(d, cfg.d_ff), deps=(o,), kind="matmul")
        nodes[down] = LayerNode(down, mm(cfg.d_ff, d), deps=(up, gate),
                                kind="matmul")
        prev = (down,)
    return LayerGraph(nodes)


def attach_weights(graph: LayerGraph, weights: Dict[str, np.ndarray]) -> LayerGraph:
    """Attach real 2-D weights (kh*kw*cin, cout) to named nodes; the
    allocator then uses exact group-set survival counts."""
    for name, w in weights.items():
        node = graph.nodes[name]
        l = node.layer
        expect = (l.kh * l.kw * l.cin, l.cout)
        if tuple(w.shape) != expect:
            raise ValueError(f"{name}: weight {w.shape} != expected {expect}")
        node.weight = np.asarray(w)
    return graph
