from repro_torch.data.convex import (biased_split, make_binary_dataset,
                                     unbiased_split)
from repro_torch.data.federated import (FederatedBatcher,
                                        SeedAddressedBatcher,
                                        client_sample_sizes)
from repro_torch.data.synthetic import (TokenStream, encoder_embed_stub,
                                        make_batch)

__all__ = ["FederatedBatcher", "SeedAddressedBatcher", "TokenStream",
           "biased_split", "client_sample_sizes", "encoder_embed_stub",
           "make_batch", "make_binary_dataset", "unbiased_split"]
