from repro_torch.data.convex import make_binary_dataset

__all__ = ["make_binary_dataset"]
