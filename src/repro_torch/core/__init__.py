"""OmniInfer core of the PyTorch port: the proxy (OmniProxy:
disaggregation-aware global scheduling) and OmniAttn's offline half (pattern
search and fidelity); both are host code."""
