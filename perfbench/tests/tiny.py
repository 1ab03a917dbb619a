"""Small sizes for the CPU tests: a tiny model configuration in the
benchmark's config-file layout and tiny versions of the cells' streams."""

from __future__ import annotations

import copy
import json

from perfbench.harness import registry


def tiny_config(compute_dtype: str = "float32", audio: str = "group") -> dict:
    cfg = registry.config_file(registry.load_benchmark(),
                               "flagship" if audio == "group" else "wavlm_large")
    cfg = copy.deepcopy(cfg)
    cfg["model"].update(adapter_dim=8, shared_dim=16, num_heads=4, proj_dim=32,
                        classifier_layers=3, classifier_base_dim=32,
                        compute_dtype=compute_dtype)
    cfg["audio"].update(conv_dim=[8, 8], conv_stride=[10, 8], conv_kernel=[10, 3],
                        hidden_size=16, num_hidden_layers=2, num_attention_heads=4,
                        intermediate_size=32, num_conv_pos_embeddings=16,
                        num_conv_pos_embedding_groups=4)
    cfg["text"].update(vocab_size=100, hidden_size=16, num_hidden_layers=2,
                       num_attention_heads=4, intermediate_size=32,
                       max_position_embeddings=40)
    return cfg


def tiny_workload(cell: str, batches=(3, 2, 1), cycles: int = 1) -> dict:
    wl = copy.deepcopy(registry.workload_file(cell))
    for b, n in zip(wl["params"]["buckets"], batches):
        b["batch"] = n
    wl["params"]["cycles"] = cycles
    return wl


def dumps(obj) -> str:
    return json.dumps(obj, sort_keys=True)
