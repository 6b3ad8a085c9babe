"""Node groups of the model families, their cost models, the OTO facade,
and the automatic grouping of any other model from its traced graph
(``quantized_vit_tpu/graph``)."""

from .autogroups import (StemPlan, discover_node_groups, trace_apply,
                         trace_cost_report)
from .builders import (autoencoder_node_groups, lora_embedding_entries,
                       lora_layer_entries, mark_unprunable,
                       mobilenet_node_groups, resnet_node_groups,
                       transformer_node_groups, ultranet_node_groups,
                       vit_node_groups)
from .costs import (autoencoder_cost_report, mobilenet_cost_report,
                    resnet_cost_report, transformer_cost_report,
                    ultranet_cost_report, vit_cost_report)
from .oto import OTO
from .tracer import TracedGraph, TraceNode, validate_node_groups

__all__ = ["OTO", "discover_node_groups", "trace_cost_report", "StemPlan",
           "trace_apply",
           "TracedGraph", "TraceNode", "validate_node_groups",
           "vit_node_groups", "resnet_node_groups",
           "autoencoder_node_groups", "mobilenet_node_groups",
           "transformer_node_groups", "ultranet_node_groups",
           "lora_layer_entries", "lora_embedding_entries", "mark_unprunable",
           "vit_cost_report", "resnet_cost_report", "mobilenet_cost_report",
           "transformer_cost_report", "ultranet_cost_report",
           "autoencoder_cost_report"]
