from repro_torch.models import attention, common, logreg, ssm

__all__ = ["attention", "common", "logreg", "ssm"]
