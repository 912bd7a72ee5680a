"""comet_tpu_torch.Fusion against comet_tpu's: each FusionKind on seeded
score maps (ties included) gives the same dict, float64 for float64."""

import numpy as np
import pytest

import comet_tpu.fusion as ref
import comet_tpu_torch.fusion as port
from comet_tpu.types import FusionKind as RefKind
from comet_tpu_torch import FusionKind, InvalidConfigError


def _maps(seed):
    rng = np.random.default_rng(seed)
    ids = rng.choice(200, size=80, replace=False)
    v = {int(i): float(s) for i, s in zip(ids[:50], rng.integers(0, 6, size=50) / 4)}
    t = {int(i): float(s) for i, s in zip(ids[30:], rng.normal(size=50))}
    return v, t


@pytest.mark.parametrize("kind", list(FusionKind))
@pytest.mark.parametrize("config", [None, (0.3, 1.7, 10.0)])
@pytest.mark.parametrize("seed", range(2))
def test_every_kind_gives_the_reference_dict(kind, config, seed):
    v, t = _maps(seed)
    rcfg = pcfg = None
    if config is not None:
        rcfg, pcfg = ref.FusionConfig(*config), port.FusionConfig(*config)
    for vv, tt in ((v, t), (v, {}), ({}, t), ({}, {})):
        want = ref.new_fusion(RefKind(kind.value), rcfg).combine(vv, tt)
        got = port.new_fusion(kind, pcfg).combine(vv, tt)
        assert got == want
        assert list(got) == list(want)


def test_default_fusion_and_unknown_kind():
    assert port.default_fusion().kind() == FusionKind.WEIGHTED_SUM
    assert port.default_fusion_config() == port.FusionConfig()
    with pytest.raises(ValueError):
        port.Fusion("bogus")
    f = port.Fusion(FusionKind.MAX)
    f._kind = "bogus"
    with pytest.raises(InvalidConfigError):
        f.combine({1: 1.0}, {2: 2.0})
