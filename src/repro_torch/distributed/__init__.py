"""repro_torch.distributed: placement rules and the row-parallel commit GEMM."""
