"""The port's config dataclasses against the reference's: same classes,
fields, defaults and JSON form, so every preset loads the same in both."""
import dataclasses
import glob
import json
import os

import pytest

import instsearch_tpu.config as jcfg
import instsearch_torch.config as tcfg

_CLASSES = ["ExtractConfig", "IndexConfig", "SearchConfig", "EvalConfig",
            "TrainConfig", "PipelineConfig"]
_PRESETS = sorted(glob.glob(os.path.join(
    os.path.dirname(os.path.dirname(os.path.abspath(__file__))),
    "configs", "*.json")))


@pytest.mark.parametrize("name", _CLASSES)
def test_same_fields_and_defaults(name):
    j, t = getattr(jcfg, name), getattr(tcfg, name)
    jf = [(f.name, f.type) for f in dataclasses.fields(j)]
    tf = [(f.name, f.type) for f in dataclasses.fields(t)]
    assert tf == jf
    assert json.loads(t().to_json()) == json.loads(j().to_json())


@pytest.mark.parametrize("path", _PRESETS, ids=os.path.basename)
def test_presets_load_the_same(path):
    j = jcfg.PipelineConfig.load(path)
    t = tcfg.PipelineConfig.load(path)
    assert json.loads(t.to_json()) == json.loads(j.to_json())
    assert isinstance(t.extract, tcfg.ExtractConfig)


def test_descriptor_dim_reads_the_port_registry():
    assert tcfg.ExtractConfig(backbone="resnet50").descriptor_dim == 2048
    assert tcfg.ExtractConfig(whiten=True, whiten_dim=512).descriptor_dim == 512
    assert tcfg.ExtractConfig(backbone="vit_b_16").descriptor_dim == 768
    assert tcfg.ExtractConfig(backbone="vit_l_16").descriptor_dim == 1024
    assert tcfg.ExtractConfig(backbone="vgg16").descriptor_dim == 512
    with pytest.raises(ValueError):
        tcfg.ExtractConfig.from_dict({"bakbone": "resnet50"})
