"""Plain PyTorch version of the SSD scan kernels: the chunked SSD of the
reference's ``repro/models/ssm.py::ssd_chunked`` (its oracle), op for op
with the reference's defaults (f32 intra-chunk tensors, the two-step
scores, a sequential inter-chunk scan), split into the kernels' four
phases (``ssd_cb``, ``ssd_chunk_states``, ``ssd_state_passing``,
``ssd_chunk_outputs``) on the chunked inputs of ``ssd_chunks``;
``ssd_chunked`` composes them.  ``repro_torch.models.ssm`` re-exports
it."""
from __future__ import annotations

import torch
import torch.nn.functional as F

F32 = torch.float32


def ssd_chunks(x, dt, A, B, C, chunk: int):
    """The inputs cut into chunks of Q = min(chunk, s) steps, s padded to
    a multiple of Q with zeros (dt = 0: no update), in f32: (xf
    (b,nc,Q,h,p), dtf (b,nc,Q,h), Af (h,), Bc (b,nc,Q,n), Cc (b,nc,Q,n))."""
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
    return xf, dtf, A.to(F32), Bc, Cc


def ssd_cb(Cc, Bc):
    """Phase 1: C B^T per chunk, (b,nc,Q,Q) (the kernel keeps j <= i)."""
    return torch.einsum("bcin,bcjn->bcij", Cc, Bc)


def ssd_chunk_states(xf, dtf, Af, Bc):
    """Phase 2: (dA_cum (b,nc,Q,h), each chunk's own end state
    (b,nc,h,n,p): its inputs decayed to the chunk's end)."""
    h = Af.shape[0]
    dA = dtf * Af.reshape(1, 1, 1, h)                          # (b,nc,Q,h)
    dA_cum = torch.cumsum(dA, dim=2)
    dA_sum = dA_cum[:, :, -1]                                  # (b,nc,h)
    w = torch.exp(dA_sum[:, :, None] - dA_cum) * dtf           # (b,nc,Q,h)
    states = torch.einsum("bcjh,bcjn,bcjhp->bchnp", w, Bc, xf)  # (b,nc,h,n,p)
    return dA_cum, states


def ssd_state_passing(states, dA_cum, initial_state=None):
    """Phase 3: (the state before each chunk (b,nc,h,n,p), the final
    state (b,h,n,p)), from the initial state (zeros if None)."""
    b, nc, h, n, p = states.shape
    dA_sum = dA_cum[:, :, -1]                                  # (b,nc,h)
    carry = (torch.zeros((b, h, n, p), dtype=F32, device=states.device)
             if initial_state is None else initial_state.to(F32))
    prev = []
    for ci in range(nc):                     # the reference's lax.scan
        prev.append(carry)
        carry = carry * torch.exp(dA_sum[:, ci])[..., None, None] \
            + states[:, ci]
    return torch.stack(prev, dim=1), carry


def ssd_chunk_outputs(xf, dtf, dA_cum, Cc, CB, prev):
    """Phase 4: y per chunk (b,nc,Q,h,p) f32: the causal products within
    the chunk plus the state before it read out through C."""
    Q = xf.shape[2]
    # intra-chunk decay matrix L[i,j] = exp(dA_cum[i] - dA_cum[j]), j <= i.
    # The mask goes in before the exp (exp(-inf) = 0): above the diagonal
    # seg > 0 and its exp overflows at mamba2-780m's width, and where()'s
    # gradient would multiply that inf by 0 (NaN, the reference's
    # ssm.py:85-87).  L's values are the same bits either way
    seg = dA_cum[:, :, :, None, :] - dA_cum[:, :, None, :, :]  # (b,nc,Q,Q,h)
    tril = torch.tril(torch.ones((Q, Q), dtype=torch.bool, device=xf.device))
    L = torch.exp(torch.where(tril[None, None, :, :, None], seg,
                              float("-inf")))
    scores = (CB[..., None] * L) * dtf[:, :, None, :, :]
    Y_diag = torch.einsum("bcijh,bcjhp->bcihp", scores, xf)
    Y_off = torch.einsum("bcin,bcih,bchnp->bcihp", Cc, torch.exp(dA_cum),
                         prev)
    return Y_diag + Y_off


def ssd_chunked(x, dt, A, B, C, chunk: int, initial_state=None):
    """SSD over a full sequence: the four phases composed.

    x: (b,s,h,p)  dt: (b,s,h)  A: (h,)  B,C: (b,s,n)  (single group).
    Returns (y (b,s,h,p) in x's dtype, final_state (b,h,n,p) f32).
    """
    b, s_orig, h, p = x.shape
    xf, dtf, Af, Bc, Cc = ssd_chunks(x, dt, A, B, C, chunk)
    CB = ssd_cb(Cc, Bc)
    dA_cum, states = ssd_chunk_states(xf, dtf, Af, Bc)
    prev, final = ssd_state_passing(states, dA_cum, initial_state)
    y = ssd_chunk_outputs(xf, dtf, dA_cum, Cc, CB, prev)
    y = y.reshape(b, -1, h, p)[:, :s_orig].to(x.dtype)
    return y, final


def ssd_ref(x, dt, A, B, C, chunk: int = 128):
    y, _ = ssd_chunked(x, dt, A, B, C, chunk)
    return y
