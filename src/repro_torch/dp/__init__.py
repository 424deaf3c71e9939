from repro_torch.dp.accountant import moments_epsilon, per_client_accounting

__all__ = ["moments_epsilon", "per_client_accounting"]
