from repro_torch.models import (attention, common, encdec, logreg, mlp, moe,
                                ssm, transformer)
from repro_torch.models.model import (forward_prefill, init_cache,
                                      init_params, serve_step, train_loss)

__all__ = ["attention", "common", "encdec", "forward_prefill", "init_cache",
           "init_params", "logreg", "mlp", "moe", "serve_step", "ssm",
           "train_loss", "transformer"]
