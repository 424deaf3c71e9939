"""Model flops of one local step, for the step's share of the chip's peak.

Forward and backward of the model on the step's examples or tokens, as
the mathematics needs them: no recomputation (remat) is counted, and the
count is the same whatever implements the step.
"""
from __future__ import annotations


def logreg_step_flops(D: int) -> float:
    """One example through the logistic regression of D parameters
    (weights and bias): the usual 6 flops a parameter an example, 2 for
    the forward product and 4 for the backward."""
    return 6.0 * D
