from repro_torch.optim.sgd import SGD, AdamState, AdamW, SGDState

__all__ = ["SGD", "AdamState", "AdamW", "SGDState"]
