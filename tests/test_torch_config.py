"""The port's config module parses every shipped YAML to the same fields as
the JAX package's."""

import dataclasses
import glob
import os

import pytest

from longlive_torch import config as TC
from longlive_tpu import config as JC

CONFIGS = sorted(glob.glob(os.path.join(os.path.dirname(__file__), "..", "configs", "*.yaml")))


@pytest.mark.parametrize("path", CONFIGS, ids=[os.path.basename(p) for p in CONFIGS])
def test_yaml_parses_to_equal_fields(path):
    pt, pj = TC.load_pipeline_config(path), JC.load_pipeline_config(path)
    assert dataclasses.asdict(pt) == dataclasses.asdict(pj)
    assert dataclasses.asdict(pt.dit_config()) == dataclasses.asdict(pj.dit_config())


def test_key_tables_and_presets_match():
    assert TC.RECOGNIZED_KEYS == JC.RECOGNIZED_KEYS
    assert TC.WAN_MODEL_CONFIGS == JC.WAN_MODEL_CONFIGS
    assert dataclasses.asdict(TC.tiny_dit_config()) == dataclasses.asdict(JC.tiny_dit_config())
    assert dataclasses.asdict(TC.tiny_geometry()) == dataclasses.asdict(JC.tiny_geometry())
    for cls in ("DiTConfig", "LatentGeometry", "CacheConfig", "PipelineConfig"):
        assert (dataclasses.asdict(getattr(TC, cls)())
                == dataclasses.asdict(getattr(JC, cls)())), cls
    geom = TC.LatentGeometry()
    assert geom.frame_seq_length == JC.LatentGeometry().frame_seq_length == 1560
    cc_t = TC.CacheConfig.from_model(TC.DiTConfig(), geom, 120)
    cc_j = JC.CacheConfig.from_model(JC.DiTConfig(), JC.LatentGeometry(), 120)
    assert dataclasses.asdict(cc_t) == dataclasses.asdict(cc_j)
    assert cc_t.size_tokens == 18720
