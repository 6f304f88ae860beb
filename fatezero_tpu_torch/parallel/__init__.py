"""Device parallelism of the port: the (data, seq, tensor) mesh over torch.distributed."""
