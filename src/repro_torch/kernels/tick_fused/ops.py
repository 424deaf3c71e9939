"""Dispatch for the fused tick kernels: by the tensors' device.

A CUDA tensor goes to the CUDA kernel (``kernel.py``) or the call
raises; a CPU tensor goes to the plain PyTorch version (``ref.py``).
There is no fallback from one to the other.  The wrappers take the
engine's natural dtypes (bool masks and flags, int64 ring indices) and
hand the kernels exactly what they check for.
"""
from __future__ import annotations

import torch

from repro_torch.kernels import row_tiles
from repro_torch.kernels.tick_fused.kernel import (
    bucket_apply_kernel, server_apply_kernel, tick_deliver_kernel,
    tick_scatter_finish_kernel, tick_scatter_kernel,
    tick_scatter_rows_kernel)
from repro_torch.kernels.tick_fused.ref import (SCATTER_TILE_ROWS,
                                                bucket_apply_ref,
                                                server_apply_ref,
                                                tick_deliver_ref,
                                                tick_scatter_finish_twin,
                                                tick_scatter_ref,
                                                tick_scatter_rows_twin)


def on_cuda(t: torch.Tensor) -> bool:
    """True for a CUDA tensor, False for a CPU one; raises otherwise."""
    if t.device.type == "cuda":
        return True
    if t.device.type == "cpu":
        return False
    raise ValueError(f"no kernel or plain version for device {t.device}")


def no_backward(kernel: str, *tensors) -> None:
    """Raises where autograd would need ``kernel``'s backward, which it
    lacks: grad mode is on and an input requires grad.  The plain
    version (a CPU tensor) differentiates."""
    if torch.is_grad_enabled() and any(
            t is not None and t.requires_grad for t in tensors):
        raise RuntimeError(
            f"the {kernel} kernel has no backward: call it under "
            f"torch.no_grad() or on inputs that do not require grad")


def bucket_apply(v, rows, dec, flag):
    """v [D], rows [A, D], dec [A], flag [] bool tensor -> [D]: the
    ``server_apply`` kernel with only the apply."""
    if not on_cuda(v):
        return bucket_apply_ref(v, rows, dec, flag)
    # the kernel reads the flag on the device: no host round trip
    return bucket_apply_kernel(v.contiguous(), rows.contiguous(),
                               dec.contiguous(), flag)


def server_apply(v, due, dec, has_arr, *, ovf=None, ovf_hit=None,
                 reset=False, buf=None, flush=None, bc_v=None, fired=None):
    """The server's step of a tick (``server_apply_ref`` says what it
    computes); returns v' and writes buf, the reset rows and bc_v in
    place, so those must be contiguous.  One launch on the card, its
    flags read there."""
    kw = dict(ovf=ovf, ovf_hit=ovf_hit, reset=reset, buf=buf, flush=flush,
              bc_v=bc_v, fired=fired)
    if not on_cuda(v):
        return server_apply_ref(v, due, dec, has_arr, **kw)
    return server_apply_kernel(v, due, dec, has_arr, **kw)


def tick_deliver(w, U, bc_v, best, take, eta):
    """w, U [C, D]; bc_v [B, D]; best [C] int; take [C] bool; eta [C]."""
    if not on_cuda(w):
        return tick_deliver_ref(w, U, bc_v, best, take, eta)
    return tick_deliver_kernel(w.contiguous(), U.contiguous(),
                               bc_v.contiguous(), best.to(torch.int64),
                               take.to(torch.bool), eta.contiguous())


def tick_scatter(sent, w, U, upd, wgt, any_g, done, eta, *, dp_on: bool):
    """sent, w, U [C, D]; upd [G, D]; wgt [G, C]; any_g [G] bool;
    done [C] bool; eta [C] -> (w', U', upd')."""
    if not on_cuda(sent):
        return tick_scatter_ref(sent, w, U, upd, wgt, any_g, done, eta,
                                dp_on=dp_on)
    return tick_scatter_kernel(sent.contiguous(), w.contiguous(),
                               U.contiguous(), upd.contiguous(),
                               wgt.contiguous(), any_g.to(torch.bool),
                               done.to(torch.bool), eta.contiguous(),
                               dp_on=dp_on)


def scatter_partition(C: int):
    """(rows per block, blocks) of tick_scatter's partition of ``C``
    client rows: ``row_tiles.cuh``'s, the same on the card and here."""
    return row_tiles.partition(C, SCATTER_TILE_ROWS)


def tick_scatter_rows(sent, w, U, wgt, done, eta, *, dp_on: bool,
                      rows_per_block: int, row_offset: int = 0, carry=None,
                      out=None):
    """tick_scatter's rows pass alone: (w', U', partials [blocks, G, D])
    of ``n`` client rows whose row 0 sits at ``row_offset`` of its block
    of ``rows_per_block`` rows, block 0 started from ``carry`` [G, D]
    where given.  The plain version is ``tick_scatter_rows_twin`` (the
    kernel's add order).  ``out``: (w_out, u_out) to write w', U' into."""
    if not on_cuda(sent):
        w_new, U_new, part = tick_scatter_rows_twin(
            sent, w, U, wgt, done, eta, dp_on=dp_on,
            rows_per_block=rows_per_block, row_offset=row_offset,
            carry=carry)
        if out is not None:
            out[0].copy_(w_new)
            out[1].copy_(U_new)
            w_new, U_new = out
        return w_new, U_new, part
    if wgt.stride(-1) != 1:            # a transposed mask, say
        wgt = wgt.contiguous()
    return tick_scatter_rows_kernel(
        sent.contiguous(), w.contiguous(), U.contiguous(), wgt,
        done.to(torch.bool).contiguous(), eta.contiguous(), dp_on=dp_on,
        rows_per_block=rows_per_block, row_offset=row_offset,
        carry=None if carry is None else carry.contiguous(), out=out)


def tick_scatter_finish(partial, upd, any_g):
    """tick_scatter's finish pass alone over ``partial`` [blocks, G, D]
    (``tick_scatter_finish_twin`` says what it computes)."""
    if not on_cuda(partial):
        return tick_scatter_finish_twin(partial, upd, any_g)
    return tick_scatter_finish_kernel(
        partial.contiguous(), None if upd is None else upd.contiguous(),
        None if any_g is None else any_g.to(torch.bool))
