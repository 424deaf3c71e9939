"""The paper's own experiment model: (strongly-)convex logistic regression.

loss(w) = BCE(sigmoid(x·w + b), y) [+ lambda/2 ||w||^2 for strong convexity]
Matches §E.1 equations (32)/(strongly convex J-hat).

Params are ``{"w": [..., d], "b": [...]}`` tensors; every function takes
a leading batch of examples (or clients) so the cohort engine runs the
whole population in one call.
"""
from __future__ import annotations

from typing import Dict, Tuple

import torch

from repro_torch import prng


def init_params(d_features: int, key=None,
                device=None) -> Dict[str, torch.Tensor]:
    """``0.01 * normal(key)`` weights and a zero bias; ``key`` defaults to
    ``PRNGKey(0)`` (the reference's default draw, within a few ulp)."""
    if key is None:
        key = prng.PRNGKey(0)
    w = 0.01 * prng.normal(key, (d_features,), device=device)
    return {"w": w, "b": torch.zeros((), dtype=torch.float32, device=device)}


def predict_logits(params, x: torch.Tensor) -> torch.Tensor:
    """x: (..., d) -> the logits x·w + b, (...)."""
    return x @ params["w"] + params["b"]


def _bce_with_logits(z: torch.Tensor, y: torch.Tensor) -> torch.Tensor:
    # numerically stable BCE-with-logits
    return (torch.clamp(z, min=0.0) - z * y
            + torch.log1p(torch.exp(-torch.abs(z))))


def per_example_loss(params, x, y, l2: float = 0.0):
    """x: (d,), y: scalar in {0,1}.  The loss of one example, for
    ``torch.func`` (``dp.mechanism.dp_sgd_round``); its autograd takes
    jax's derivatives at ``z == 0``: ``torch.maximum`` splits the tie in
    half as ``jnp.maximum`` does, and ``|z|`` is written as a select so
    that it takes ``+g`` at 0 as jax's ``abs`` does."""
    z = x @ params["w"] + params["b"]
    az = torch.where(z >= 0.0, z, -z)
    # numerically stable BCE-with-logits
    loss = (torch.maximum(z, torch.zeros_like(z)) - z * y
            + torch.log1p(torch.exp(-az)))
    if l2 > 0.0:
        loss = loss + 0.5 * l2 * torch.sum(torch.square(params["w"]))
    return loss


def per_example_grad(w: torch.Tensor, b: torch.Tensor, x: torch.Tensor,
                     y: torch.Tensor, l2: float = 0.0
                     ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Closed-form gradient of ``per_example_loss`` for a batch.

    w, x: [N, d]; b, y: [N].  Written as jax's autodiff computes it:
    ``maximum(z, 0)`` splits a tie at ``z == 0`` in half (balanced
    equality), ``abs`` takes ``+g`` at ``z == 0``, and the l2 term acts on
    ``w`` only, as ``c * (2 * w)`` with ``c = f32(0.5 * l2)``.
    """
    z = (x * w).sum(dim=-1) + b
    ans = torch.clamp(z, min=0.0)
    bal = ((z == ans).to(torch.float32)
           / torch.where(ans == 0.0, 2.0, 1.0))
    e = torch.exp(-torch.abs(z))
    t = (1.0 / (e + 1.0)) * e                 # log1p' then exp'
    t_abs = torch.where(z >= 0.0, -t, t)      # neg then abs'
    dz = (t_abs - y) + bal
    gw = x * dz[..., None]
    if l2 > 0.0:
        gw = gw + (0.5 * l2) * (2.0 * w)
    return gw, dz


def batch_loss(params, xb: torch.Tensor, yb: torch.Tensor,
               l2: float = 0.0) -> torch.Tensor:
    z = xb @ params["w"] + params["b"]
    loss = torch.mean(_bce_with_logits(z, yb))
    if l2 > 0.0:
        loss = loss + 0.5 * l2 * torch.sum(torch.square(params["w"]))
    return loss


def accuracy(params, xb: torch.Tensor, yb: torch.Tensor) -> torch.Tensor:
    pred = ((xb @ params["w"] + params["b"]) > 0).to(torch.float32)
    return torch.mean((pred == yb).to(torch.float32))
