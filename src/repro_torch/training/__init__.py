"""repro_torch.training."""
