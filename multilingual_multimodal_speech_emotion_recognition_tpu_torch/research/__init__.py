"""Research-halo modules of the port, plain PyTorch.

temporal           — PE, causal TCN, smoothing, speaker change, segment buffer
dual_gate_ood      — early quality gate + energy ⊕ Mahalanobis late gate
confidence_fusion  — dynamic gating MLP, policy clamps, adaptive fusion
cross_lingual      — gradient reversal, adversarial language head, adapters
loss_integration   — phase schedule, energy-margin / temporal / calibration losses
"""

from . import confidence_fusion, cross_lingual, dual_gate_ood, loss_integration, temporal

__all__ = ["confidence_fusion", "cross_lingual", "dual_gate_ood", "loss_integration",
           "temporal"]
