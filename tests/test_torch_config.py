"""Port config == JAX config: output-dir naming is byte-identical."""

import pytest

from hgaprec_tpu import config as jcfg
from hgaprec_tpu_torch import config as tcfg

GRID = [
    ({}, {}),
    ({"variant": "hpf"}, {"datdir": "data/ml-1m"}),
    ({"variant": "hpf", "bias": True}, {"seed": 7, "label": "run"}),
    ({"binary": True, "vb": False}, {"batch": False, "datdir": "/x/netflix"}),
    ({"a": 0.5, "d": 1.25}, {"datdir": "a1"}),
    ({"variant": "mle_user"}, {"nmf": True, "write_training": True}),
    ({"variant": "canny"}, {"chi": True, "chi_tool": "wals", "wals_l": 0.5,
                            "wals_C": 3}),
    ({"variant": "mle_item"}, {"lda": True, "vwlda": True, "ctr": True}),
    ({}, {"chi": True, "chi_tool": "climf", "datdir": "9data"}),
]


@pytest.mark.parametrize("model_kw,run_kw", GRID)
def test_derive_outdir_equal(model_kw, run_kw):
    jm = jcfg.ModelConfig(n=6040, m=3681, k=100, **model_kw)
    tm = tcfg.ModelConfig(n=6040, m=3681, k=100, **model_kw)
    jr = jcfg.RunConfig(**run_kw)
    tr = tcfg.RunConfig(**run_kw)
    assert tr.derive_outdir(tm) == jr.derive_outdir(jm)
    assert tm.resolve_sweep() == jm.resolve_sweep()


def test_config_rejects_unported_values():
    for impl in ("pallas", "mxu"):       # TPU implementations of the tail
        with pytest.raises(ValueError):
            tcfg.ModelConfig(n=2, m=2, k=1, tail_impl=impl)
    with pytest.raises(ValueError):
        tcfg.ModelConfig(n=2, m=2, k=1, matmul_precision="high")
