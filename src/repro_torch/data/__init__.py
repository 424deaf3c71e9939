from repro_torch.data.convex import (biased_split, make_binary_dataset,
                                     unbiased_split)

__all__ = ["biased_split", "make_binary_dataset", "unbiased_split"]
