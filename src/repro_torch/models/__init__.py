from repro_torch.models import logreg

__all__ = ["logreg"]
