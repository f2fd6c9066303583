from scene_generation_tpu_torch.data.batching import Batch, Example, collate
from scene_generation_tpu_torch.data.synthetic import (synthetic_batch,
                                                       synthetic_vocab)

__all__ = ["Batch", "Example", "collate", "synthetic_batch",
           "synthetic_vocab"]
