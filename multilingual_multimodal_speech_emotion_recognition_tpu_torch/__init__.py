"""PyTorch and CUDA port of the multilingual multimodal speech emotion
recognition system, for an NVIDIA H100."""
