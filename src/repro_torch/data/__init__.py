from repro_torch.data.convex import (biased_split, make_binary_dataset,
                                     unbiased_split)
from repro_torch.data.synthetic import (TokenStream, encoder_embed_stub,
                                        make_batch)

__all__ = ["TokenStream", "biased_split", "encoder_embed_stub",
           "make_batch", "make_binary_dataset", "unbiased_split"]
