"""The comparison that decides `correct`, driven through a whole run on
the CPU at a size a test can hold (the look for a card skipped, the
port's plain versions in place of its kernels):

  * a sound run of every cell is correct;
  * with the timed path broken underneath, `correct` comes out false, once
    for each fault a one-card cell can have: a step that returns its
    state unchanged; half of the nonzeros left out and the mean taken
    over the rest; an element of the state altered where it is produced
    (no cell has an exchange between cards to leave out);
  * the control, the reference in TF32 put in the program's place, fails
    each cell's limits.

On a card, `test_sound_run_on_card` makes one run of each cell at the
small size through the port's kernels."""

import dataclasses
import json
import time

import pytest
import torch

import hgaprec_tpu_torch.models.step as step_mod
from hpfbench import compare, data, manifest, run
from hpfbench.state_init import hpf_initial_state

BENCH = manifest.load()
CELLS = [w["name"] for w in BENCH["workloads"]]
SMALL = {
    # hybrid at this size: no dense Y, a head of 512 items and a tail
    "echonest-hpf-k100": {"users": 3000, "items": 2500, "nnz": 30000,
                          "layout": {"hybrid_head_items": 512,
                                     "dense_limit_bytes": 1000,
                                     "head_limit_bytes": 4 << 30}},
}


@pytest.fixture(scope="module")
def small_root(tmp_path_factory):
    """A checkout root whose BENCHMARK.json names small copies of the
    configurations (K = 8), every other file the benchmark's own."""
    root = tmp_path_factory.mktemp("small")
    bench = json.loads(json.dumps(BENCH))
    for entry in bench["configs"]:
        cfg = manifest.config(BENCH, entry["name"])
        cfg.update(SMALL[entry["name"]], k=8)
        entry["file"] = f"{entry['name']}.json"
        (root / entry["file"]).write_text(json.dumps(cfg))
    (root / "BENCHMARK.json").write_text(json.dumps(bench))
    return str(root)


def execute(root, cell, seed=2**31 + 11, device="cpu"):
    return run.execute(cell, seed, 0.05, False, device, root=root,
                       t_start=time.perf_counter())


@pytest.mark.parametrize("cell", CELLS)
def test_sound_run_is_correct(small_root, cell):
    result = execute(small_root, cell)
    assert result["correct"], result["checks"]
    assert result["attempted"] == 3 and result["failed"] == 0
    assert list(result)[-1] == "checks"
    assert set(result["metrics"]) == {"iter_ms", "setup_s"}


def _halved(data_):
    """The nonzeros at odd positions (of the COO, of a tail, or of a dense
    block by the parity of row + column) left out, the rest doubled."""
    def keep(y):
        return y * (torch.arange(y.shape[0]) % 2 == 0) * 2

    def dense(y):
        if y is None:
            return None
        rows = torch.arange(y.shape[0])[:, None]
        cols = torch.arange(y.shape[1])[None, :]
        return (y * ((rows + cols) % 2 == 0) * 2).to(y.dtype)

    tail = data_.tail
    if tail is not None:
        y = keep(tail.y)
        tail = dataclasses.replace(tail, y=y,
                                   y_by_item=y[tail.order.long()])
    y = keep(data_.y)
    return dataclasses.replace(data_, y=y, dense_y=dense(data_.dense_y),
                               head_dense_y=dense(data_.head_dense_y),
                               tail=tail)


def _plant(monkeypatch, fault):
    real_step, real_sweep = step_mod.cavi_step, step_mod._sweep
    if fault == "unchanged":
        monkeypatch.setattr(step_mod, "cavi_step",
                            lambda state, *a, **k: state)
    elif fault == "half_batch":
        monkeypatch.setattr(
            step_mod, "_sweep",
            lambda state, data_, *a, **k: real_sweep(state, _halved(data_),
                                                     *a, **k))
    elif fault == "altered":
        def altered(state, *a, **k):
            real_step(state, *a, **k)
            state.theta.shape.view(-1)[0] *= 1.01
            return state
        monkeypatch.setattr(step_mod, "cavi_step", altered)


@pytest.mark.parametrize("fault", ["unchanged", "half_batch", "altered"])
@pytest.mark.parametrize("cell", CELLS)
def test_broken_timed_path_is_not_correct(small_root, monkeypatch, cell,
                                          fault):
    _plant(monkeypatch, fault)
    result = execute(small_root, cell)
    assert not result["correct"]
    assert result["failed"] >= 1


@pytest.mark.parametrize("cell", CELLS)
def test_control_fails_the_limits(small_root, cell):
    """The TF32 control held to the float64 reference on the same COO and
    initial state: every number over its limit, on every seed."""
    wl = manifest.workload(BENCH, cell)
    bench = manifest.load(small_root)
    cfg = manifest.config(bench, wl["config"], small_root)
    limits = manifest.limits(cell)
    ref = manifest.module("refs", cfg["reference"])
    worst = []
    for seed in (1, 2, 3):
        gen = torch.Generator().manual_seed(seed)
        coo = data.make_coo(cfg, gen, "cpu")
        st0 = hpf_initial_state(coo.n, coo.m, cfg["k"], cfg["priors"], gen,
                                "cpu")
        exact = {k: v.double() for k, v in st0.items()}
        low = st0
        numbers = {}
        for s in range(1, len(limits) + 1):
            exact = ref.hpf_step(exact, coo.u, coo.i, coo.y, cfg["k"],
                                 cfg["priors"])
            low = ref.hpf_step(low, coo.u, coo.i, coo.y, cfg["k"],
                               cfg["priors"], tf32=True)
            gaps = compare.state_gaps(low, exact)
            numbers[compare.step_name(s)] = max(gaps.values())
        correct, failed = compare.judge(numbers, limits)
        assert not correct, numbers
        worst.append(min(numbers[k] / limits[k] for k in numbers))
    assert min(worst) > 1.0


@pytest.fixture
def card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the port's kernels run only there")
    return "cuda:0"


@pytest.mark.parametrize("cell", CELLS)
def test_sound_run_on_card(small_root, card, cell):
    result = execute(small_root, cell, device=card)
    assert result["correct"], result["checks"]
