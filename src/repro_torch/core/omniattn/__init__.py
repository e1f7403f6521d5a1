"""OmniAttn's offline half: the layer-wise compression pattern search
(paper §4.2) and the attention-fidelity measure it is judged by."""
from repro_torch.core.omniattn.fidelity import (attention_fidelity,
                                                block_subset_indices,
                                                sink_recent_indices)
from repro_torch.core.omniattn.search import (GAConfig, PatternSearch,
                                              kv_bytes_for_pattern)

__all__ = ["GAConfig", "PatternSearch", "kv_bytes_for_pattern",
           "attention_fidelity", "sink_recent_indices",
           "block_subset_indices"]
