"""Multi-process rendering and gradients over torch.distributed."""
