from tepdist_tpu_torch.graph.fx_graph import FxGraph, GraphNode, trace_graph

__all__ = ["FxGraph", "GraphNode", "trace_graph"]
