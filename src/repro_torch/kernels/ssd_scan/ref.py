"""Plain PyTorch version of the SSD scan kernel: the chunked SSD of the
reference's ``repro/models/ssm.py::ssd_chunked`` (its oracle), op for op
with the reference's defaults (f32 intra-chunk tensors, the two-step
scores, a sequential inter-chunk scan).  ``repro_torch.models.ssm``
re-exports it."""
from __future__ import annotations

import torch
import torch.nn.functional as F

F32 = torch.float32


def ssd_chunked(x, dt, A, B, C, chunk: int, initial_state=None):
    """SSD over a full sequence.

    x: (b,s,h,p)  dt: (b,s,h)  A: (h,)  B,C: (b,s,n)  (single group).
    Returns (y (b,s,h,p) in x's dtype, final_state (b,h,n,p) f32).
    """
    b, s_orig, h, p = x.shape
    n = B.shape[-1]
    Q = min(chunk, s_orig)
    pad = (-s_orig) % Q
    if pad:
        x = F.pad(x, (0, 0, 0, 0, 0, pad))
        dt = F.pad(dt, (0, 0, 0, pad))      # dt=0 => no update
        B = F.pad(B, (0, 0, 0, pad))
        C = F.pad(C, (0, 0, 0, pad))
    s = s_orig + pad
    nc = s // Q

    xf = x.to(F32).reshape(b, nc, Q, h, p)
    dtf = dt.to(F32).reshape(b, nc, Q, h)
    Bc = B.to(F32).reshape(b, nc, Q, n)
    Cc = C.to(F32).reshape(b, nc, Q, n)
    Af = A.to(F32)

    dA = dtf * Af.reshape(1, 1, 1, h)                          # (b,nc,Q,h)
    dA_cum = torch.cumsum(dA, dim=2)
    # intra-chunk decay matrix L[i,j] = exp(dA_cum[i] - dA_cum[j]), j <= i
    seg = dA_cum[:, :, :, None, :] - dA_cum[:, :, None, :, :]  # (b,nc,Q,Q,h)
    tril = torch.tril(torch.ones((Q, Q), dtype=torch.bool, device=x.device))
    L = torch.where(tril[None, None, :, :, None], torch.exp(seg), 0.0)

    CB = torch.einsum("bcin,bcjn->bcij", Cc, Bc)
    scores = (CB[..., None] * L) * dtf[:, :, None, :, :]
    Y_diag = torch.einsum("bcijh,bcjhp->bcihp", scores, xf)

    # per-chunk end state contribution
    dA_sum = dA_cum[:, :, -1]                                  # (b,nc,h)
    w = torch.exp(dA_sum[:, :, None] - dA_cum) * dtf           # (b,nc,Q,h)
    states = torch.einsum("bcjh,bcjn,bcjhp->bchnp", w, Bc, xf)  # (b,nc,h,n,p)

    carry = (torch.zeros((b, h, n, p), dtype=F32, device=x.device)
             if initial_state is None else initial_state.to(F32))
    prev = []
    for ci in range(nc):                     # the reference's lax.scan
        prev.append(carry)
        carry = carry * torch.exp(dA_sum[:, ci])[..., None, None] \
            + states[:, ci]
    prev = torch.stack(prev, dim=1)                            # (b,nc,h,n,p)

    Y_off = torch.einsum("bcin,bcih,bchnp->bcihp", Cc, torch.exp(dA_cum),
                         prev)
    y = (Y_diag + Y_off).reshape(b, s, h, p)[:, :s_orig].to(x.dtype)
    return y, carry


def ssd_ref(x, dt, A, B, C, chunk: int = 128):
    y, _ = ssd_chunked(x, dt, A, B, C, chunk)
    return y
