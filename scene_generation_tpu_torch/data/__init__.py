from scene_generation_tpu_torch.data.batching import Batch, Example, collate
from scene_generation_tpu_torch.data.synthetic import (SyntheticDataset,
                                                       synthetic_batch,
                                                       synthetic_vocab)

__all__ = ["Batch", "Example", "SyntheticDataset", "collate",
           "synthetic_batch", "synthetic_vocab"]
