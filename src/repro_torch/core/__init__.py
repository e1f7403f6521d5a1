"""OmniInfer core of the PyTorch port. Only the proxy (OmniProxy:
disaggregation-aware global scheduling) is ported so far; it is pure Python."""
