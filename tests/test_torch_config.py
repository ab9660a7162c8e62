"""The port's config equals the JAX package's, field for field."""

import dataclasses

import pytest

from sagnn_tpu import config as jcfg
from sagnn_tpu_torch import config as tcfg

CLASSES = ("ModelConfig", "TrainConfig", "DataConfig", "Config")


@pytest.mark.parametrize("name", CLASSES)
def test_dataclass_fields_match(name):
    jf = dataclasses.fields(getattr(jcfg, name))
    tf = dataclasses.fields(getattr(tcfg, name))
    assert [f.name for f in tf] == [f.name for f in jf]
    for a, b in zip(jf, tf):
        if a.default is not dataclasses.MISSING:
            assert b.default == a.default, a.name


@pytest.mark.parametrize("preset", sorted(jcfg.PRESETS))
def test_presets_match(preset):
    assert sorted(tcfg.PRESETS) == sorted(jcfg.PRESETS)
    assert (dataclasses.asdict(tcfg.PRESETS[preset])
            == dataclasses.asdict(jcfg.PRESETS[preset]))
    t, j = tcfg.PRESETS[preset], jcfg.PRESETS[preset]
    assert t.train.decay_step == j.train.decay_step
    assert t.train.steps_per_epoch == j.train.steps_per_epoch
    assert t.model.head_dim == j.model.head_dim
    assert t.data.predir == j.data.predir
