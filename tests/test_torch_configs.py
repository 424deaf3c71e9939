"""The port's configs (repro_torch.configs) against the live reference
(repro.configs): the registry and every registered architecture, full
and ``reduced``, field by field; the paper's logistic-regression config
and its two FL configs; and the protocol dataclasses' defaults.  Configs
are plain values, so every comparison is ``==``."""
import dataclasses

import pytest

import repro.configs as J
import repro_torch.configs as T
from repro.configs import paper_logreg as jpaper
from repro_torch.configs import paper_logreg as tpaper


def _fields(cfg):
    return {f.name: getattr(cfg, f.name) for f in dataclasses.fields(cfg)}


def test_registry_lists_the_reference_archs():
    assert T.list_archs() == J.list_archs()
    assert T.ASSIGNED_ARCHS == J.ASSIGNED_ARCHS
    with pytest.raises(KeyError, match="unknown arch"):
        T.get_config("nope")


@pytest.mark.parametrize("arch", J.list_archs())
def test_config_equals_reference_field_by_field(arch):
    jc, tc = J.get_config(arch), T.get_config(arch)
    assert _fields(tc) == _fields(jc)
    assert tc.param_count() == jc.param_count()
    assert [tc.layer_is_local(i) for i in range(tc.n_layers)] == \
        [jc.layer_is_local(i) for i in range(jc.n_layers)]


@pytest.mark.parametrize("arch", J.list_archs())
def test_reduced_config_equals_reference_field_by_field(arch):
    jc, tc = J.reduced(J.get_config(arch)), T.reduced(T.get_config(arch))
    assert _fields(tc) == _fields(jc)
    jr = J.reduced(J.get_config(arch), n_layers=1, d_model=64, vocab=300)
    tr = T.reduced(T.get_config(arch), n_layers=1, d_model=64, vocab=300)
    assert _fields(tr) == _fields(jr)


@pytest.mark.parametrize("name", ["FLConfig", "DPConfig",
                                  "SampleSequenceConfig", "StepSizeConfig"])
def test_protocol_defaults_equal_reference_field_by_field(name):
    jd = dataclasses.asdict(getattr(J, name)())
    td = dataclasses.asdict(getattr(T, name)())
    assert td.keys() == jd.keys()
    for key in jd:
        assert td[key] == jd[key], key


def test_default_engine_is_the_event_simulator():
    assert T.FLConfig().engine == J.FLConfig().engine == "event"


@pytest.mark.parametrize("name", ["fl_config_fig1a", "fl_config_fig1b"])
def test_paper_fl_configs_equal_reference(name):
    assert (dataclasses.asdict(getattr(tpaper, name)())
            == dataclasses.asdict(getattr(jpaper, name)()))
    assert getattr(T, name)() == getattr(tpaper, name)()


@pytest.mark.parametrize("d", [64, 785])
def test_paper_logreg_config_equals_reference(d):
    assert _fields(tpaper.config(d)) == _fields(jpaper.config(d))
