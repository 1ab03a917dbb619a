"""A tiny w2v-BERT 2.0 configuration in the benchmark's config-file layout:
2 conformer layers, hidden 32, 4 heads, clamps 4 / 2, a depthwise kernel
of 5, and tiny.py's sizes for the rest of the model."""

from __future__ import annotations

import copy

from perfbench.harness import registry
from perfbench.tests.tiny import tiny_config


def tiny_w2v_bert_config(compute_dtype: str = "float32") -> dict:
    cfg = copy.deepcopy(registry.config_file(registry.load_benchmark(), "w2v_bert"))
    small = tiny_config(compute_dtype)
    cfg["model"], cfg["text"] = small["model"], small["text"]
    cfg["audio"].update(hidden_size=32, num_hidden_layers=2, num_attention_heads=4,
                        intermediate_size=64, left_max_position_embeddings=4,
                        right_max_position_embeddings=2, conv_depthwise_kernel_size=5)
    return cfg
