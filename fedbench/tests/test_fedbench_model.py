"""The plain Mamba-2 reference against a 2-layer reduced run of the port
on the CPU, and the comparison's verdict on a planted fault."""
import pytest

from _small import MAMBA2, run


@pytest.mark.parametrize("seconds", [0.2, 30.0])
def test_mamba2_reference_agrees_with_the_port(seconds):
    """A window of one tick, and the cell's whole window of 8 ticks,
    whose end the check reads as well."""
    res, _ = run("mamba2_fl_dp", MAMBA2, seconds=seconds)
    assert res["correct"], res["compared"]
    assert res["compared"]["protocol_mismatches"]["value"] == 0
    assert res["compared"]["loss_gap"]["value"] < 1e-5


def test_half_the_batch_left_out_is_not_correct(monkeypatch):
    """Each step's loss over half of the minibatch, the mean over the
    rest: the run comes out not correct."""
    from repro_torch.core import BatchModelTask
    inner = BatchModelTask.loss_and_grad

    def loss_and_grad(self, params, batch):
        return inner(self, params, {"tokens": batch["tokens"][:1]})
    monkeypatch.setattr(BatchModelTask, "loss_and_grad", loss_and_grad)
    res, _ = run("mamba2_fl_dp", MAMBA2)
    assert not res["correct"]


def test_the_layout_is_the_programs():
    """The reference's flat layout (leaf names, shapes, order) is the
    program's params tree flattened, at the cell's own sizes."""
    import dataclasses
    import json

    import torch
    from _small import ROOT
    from fedbench.reference import mamba2 as ref_m
    from repro_torch import prng, tree
    from repro_torch.configs import get_config
    from repro_torch.models import init_params
    cfg = json.loads((ROOT / "fedbench/configs/mamba2_780m_l32.json")
                     .read_text())
    pcfg = dataclasses.replace(get_config(cfg["arch"]), **{
        k: cfg[k] for k in cfg["program_config"]})
    params = init_params(pcfg, prng.PRNGKey(0), torch.float32,
                         device="meta")
    assert ([tuple(l.shape) for l in tree.leaves(params)]
            == [s for _, s in ref_m.layout(cfg)])
