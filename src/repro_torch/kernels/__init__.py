"""Hand-written Hopper kernels of the port, their plain PyTorch versions and
the layout adapters the model stack calls (`ops`)."""
