"""Research-halo modules of the port, plain PyTorch: those the streaming
recognizer and the integration check need (the rest, confidence_fusion,
cross_lingual and loss_integration, are the second half of ROADMAP Queue A
item 15).

temporal       — PE, causal TCN, smoothing, speaker change, segment buffer
dual_gate_ood  — early quality gate + energy ⊕ Mahalanobis late gate
"""

from . import dual_gate_ood, temporal

__all__ = ["dual_gate_ood", "temporal"]
