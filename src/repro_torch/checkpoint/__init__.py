from repro_torch.checkpoint.io import (load_fl_state, load_pytree,
                                       save_fl_state, save_pytree)

__all__ = ["load_fl_state", "load_pytree", "save_fl_state", "save_pytree"]
