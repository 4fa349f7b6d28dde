"""The benchmark's layout is the one users get: `program.layout` hands the
port's `build_device_data` the same arguments as the Trainer does
(models/engine.py), so the card sizes each cell's hybrid head for its
precision and K as it does a user's."""

import types

import numpy as np
import pytest

import hgaprec_tpu_torch.models.engine as engine
from hgaprec_tpu_torch.config import ModelConfig, RunConfig
from hpfbench import program


class Handed(Exception):
    """Raised in place of the layout build, once its arguments are kept."""


def _recorder(monkeypatch, module, seen):
    def record(store, device, **kwargs):
        seen.append(kwargs)
        raise Handed
    monkeypatch.setattr(module, "build_device_data", record)


@pytest.mark.parametrize("sweep", ["auto", "segment-chunked"])
@pytest.mark.parametrize("precision", ["highest", "default"])
@pytest.mark.parametrize("k", [100, 300])
def test_layout_takes_the_trainers_arguments(tmp_path, monkeypatch, k,
                                             precision, sweep):
    n, m = 60, 40
    # a catalog too wide to densify: "auto" asks for a head
    mcfg = ModelConfig(n=n, m=m, k=k, variant="hpf", sweep=sweep,
                       matmul_precision=precision, dense_limit_bytes=100,
                       hybrid_head_items=16)
    rng = np.random.default_rng(0)
    u = np.sort(rng.integers(0, n, 200)).astype(np.int32)
    i = rng.integers(0, m, 200).astype(np.int32)
    y = rng.integers(1, 5, 200).astype(np.int32)
    store = types.SimpleNamespace(n=n, m=m, coo_u=u, coo_i=i, coo_y=y)
    seen = []
    _recorder(monkeypatch, engine, seen)
    _recorder(monkeypatch, program, seen)
    with pytest.raises(Handed):
        engine.Trainer(store, {}, {}, mcfg,
                       RunConfig(outdir=str(tmp_path / "out")),
                       device="cpu")
    with pytest.raises(Handed):
        program.layout(mcfg, u, i, y, "cpu")
    trainer, bench = seen
    assert bench == trainer
    assert bench["precision"] == precision and bench["kaug"] == k
    assert bench["hybrid_head_items"] == (16 if sweep == "auto" else 0)
