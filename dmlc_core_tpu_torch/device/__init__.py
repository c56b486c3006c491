"""Device data path: host batches to CUDA tensors."""
