"""repro_torch.sched - multi-macro scheduling & event-driven CIM simulation.

The pipeline: extract a layer DAG from a model config (``graph``), place
surviving group-sets onto the 4 cores x 2 macros fabric (``allocate``),
simulate the schedule event-by-event (``simulate``), search the mapping
space for a faster tiling (``search``), and execute the winner on the real
block-sparse kernel with the same artifact (``executor``); ``autotune``
times the search's top tiles through that kernel and ``pricing`` prices
requests with the simulator. Everything but ``executor`` and
``autotune.measure_tile`` is numpy on the host.
"""
from .allocate import (CoreAssignment, LayerAllocation, allocate_counts,
                       allocate_node, allocate_packing, device_assignment,
                       verify_conservation)
# NOTE: the bare function is intentionally NOT imported here - binding the
# name ``autotune`` in the package would shadow the submodule attribute
from .autotune import (AutotuneCache, AutotuneResult, autotune_key,
                       backend_name, measure_tile, projection_shapes,
                       refit_from_table)
from .graph import (LayerGraph, LayerNode, attach_weights, graph_from_layers,
                    lm_graph, resnet18_graph, vgg16_graph)
from .executor import (LayerSchedule, NetworkSchedule, build_schedule,
                       deploy_layer, execute_layer, execute_network,
                       schedule_from_search, verify_layer)
from .pricing import Pricer, RequestPrice, StepPrice
from .search import (CandidateResult, MappingCandidate, SearchResult,
                     SpecCalibration, SpecSearchResult,
                     default_candidate, greedy_search, search_mapping,
                     search_spec)
from .simulate import SimEvent, SimResult, cross_validate, simulate

__all__ = [
    "CoreAssignment", "LayerAllocation", "allocate_counts", "allocate_node",
    "allocate_packing", "device_assignment", "verify_conservation",
    "AutotuneCache", "AutotuneResult", "autotune_key", "backend_name",
    "measure_tile", "projection_shapes", "refit_from_table",
    "LayerGraph", "LayerNode", "attach_weights", "graph_from_layers",
    "lm_graph", "resnet18_graph", "vgg16_graph",
    "LayerSchedule", "NetworkSchedule", "build_schedule", "deploy_layer",
    "execute_layer", "execute_network", "schedule_from_search", "verify_layer",
    "Pricer", "RequestPrice", "StepPrice",
    "CandidateResult", "MappingCandidate", "SearchResult",
    "SpecCalibration", "SpecSearchResult", "default_candidate",
    "greedy_search", "search_mapping", "search_spec",
    "SimEvent", "SimResult", "cross_validate", "simulate",
]
