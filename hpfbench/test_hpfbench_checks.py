"""The comparison that decides `correct`, driven through a whole run on
the CPU at a size a test can hold (the look for a card skipped, the
port's plain versions in place of its kernels):

  * a sound run of every cell is correct;
  * with the timed path broken underneath, `correct` comes out false, once
    for each fault a one-card cell can have: a step that returns its
    state unchanged; half of the nonzeros left out and the mean taken
    over the rest; an element of the state altered where it is produced
    (no cell has an exchange between cards to leave out);
  * the control, the reference one precision below the cell's put in the
    program's place (TF32 below "highest", FP8 below "default"), fails
    each cell's limits;
  * a configuration and its cells added as new files and BENCHMARK.json
    entries alone pass the same checks.

Each configuration's small copy is made by one rule from its own file
(`small_copy`). On a card, `test_sound_run_on_card` makes one run of each
cell at the small size through the port's kernels."""

import dataclasses
import hashlib
import json
import os
import shutil
import time

import pytest
import torch

import hgaprec_tpu_torch.models.step as step_mod
from hgaprec_tpu_torch.data.device import head_width
from hgaprec_tpu_torch.ops.dense_fused import dense_kernel
from hpfbench import compare, data, manifest, run
from hpfbench.state_init import hpf_initial_state

BENCH = manifest.load()
CELLS = [w["name"] for w in BENCH["workloads"]]
# the small copy's longer side (users or items), and its K where the
# configuration's own takes the same kernel routes
SMALL_SIDE = 3000
SMALL_K = 8
# the most head items the small copy's layout asks for: four of the card's
# groups of 128 (data/device.py::HEAD_GROUP), within which the card narrows
SMALL_HEAD = 512
# the benchmark's data files, which a checkout's root holds under DIR
DATA_DIRS = ("configs", "traffic", "limits")


def small_copy(cfg: dict, precisions) -> dict:
    """`cfg` at a size a CPU test holds, by rule from its own numbers:

      * users, items and nonzeros scaled by one factor, the longer side to
        SMALL_SIDE, so that every user's and item's mean degree stays the
        source's, within half the cells (the generator's laws and counts as
        they are);
      * the layout limits set so that the copy takes the configuration's
        layout under every traffic mix: users x items densify as they do at
        full size; a hybrid head exists where it does at full size, at most
        SMALL_HEAD items and half the catalog (a tail stays), and fits its
        byte budget exactly; no head where there is none;
      * K = SMALL_K, unless the configuration's K takes another route of
        kernel #1 than SMALL_K's at one of `precisions` (the matmul
        precisions of its cells: past 128 values at "highest", past 256 at
        "default"), where it keeps its own."""
    out = json.loads(json.dumps(cfg))
    n, m = cfg["users"], cfg["items"]
    f = SMALL_SIDE / max(n, m, SMALL_SIDE)
    ns, ms = round(n * f), round(m * f)
    out.update(users=ns, items=ms,
               nnz=min(max(round(cfg["nnz"] * f), ns + ms), ns * ms // 2))
    lay = cfg["layout"]
    dense = n * m <= lay["dense_limit_bytes"]
    head = head_width(n, m, lay["hybrid_head_items"],
                      lay["head_limit_bytes"])
    hs = min(head, SMALL_HEAD, ms // 2)
    npad = -(-ns // 512) * 512          # the head block's rows, padded
    out["layout"] = {"dense_limit_bytes": ns * ms - (0 if dense else 1),
                     "hybrid_head_items": hs,
                     "head_limit_bytes": npad * hs}
    k = cfg["k"]
    same = all(dense_kernel(k, p == "default") ==
               dense_kernel(SMALL_K, p == "default") for p in precisions)
    out["k"] = SMALL_K if same else k
    return out


def make_small_root(src: str, dst: str) -> str:
    """A checkout root at `dst` whose BENCHMARK.json names the small
    copies of the configurations of the checkout at `src`, every other
    data file `src`'s own."""
    bench = manifest.load(src)
    for d in ("traffic", "limits"):
        shutil.copytree(os.path.join(src, manifest.DIR, d),
                        os.path.join(dst, manifest.DIR, d))
    for entry in bench["configs"]:
        precisions = {manifest.traffic(w["traffic"], src)["matmul_precision"]
                      for w in bench["workloads"]
                      if w["config"] == entry["name"]}
        cfg = small_copy(manifest.config(bench, entry["name"], src),
                         precisions)
        entry["file"] = f"{entry['name']}.json"
        with open(os.path.join(dst, entry["file"]), "w") as f:
            json.dump(cfg, f)
    with open(os.path.join(dst, "BENCHMARK.json"), "w") as f:
        json.dump(bench, f)
    return dst


@pytest.fixture(scope="module")
def small_root(tmp_path_factory):
    """A checkout root whose BENCHMARK.json names small copies of the
    configurations, every other file the benchmark's own."""
    return make_small_root(manifest.ROOT,
                           str(tmp_path_factory.mktemp("small")))


def precision(root, cell):
    wl = manifest.workload(manifest.load(root), cell)
    return manifest.traffic(wl["traffic"], root)["matmul_precision"]


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


def _plant(monkeypatch, fault, share):
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
            state.theta.shape.view(-1)[0] *= 1.0 + share
            return state
        monkeypatch.setattr(step_mod, "cavi_step", altered)


@pytest.mark.parametrize("fault", ["unchanged", "half_batch", "altered"])
@pytest.mark.parametrize("cell", CELLS)
def test_broken_timed_path_is_not_correct(small_root, monkeypatch, cell,
                                          fault):
    _plant(monkeypatch, fault,
           compare.ALTERED[precision(small_root, cell)])
    result = execute(small_root, cell)
    assert not result["correct"]
    assert result["failed"] >= 1


def control_ratios(root, cell):
    """Over three seeds, the least ratio of a number to its limit when the
    control (the reference, its products' operands rounded one precision
    below the cell's) is held to the float64 reference on the same COO and
    initial state; asserts that each seed fails the limits."""
    bench = manifest.load(root)
    wl = manifest.workload(bench, cell)
    cfg = manifest.config(bench, wl["config"], root)
    limits = manifest.limits(cell, root)
    ref = manifest.module("refs", cfg["reference"])
    low = ref.BELOW[precision(root, cell)]
    worst = []
    for seed in (1, 2, 3):
        gen = torch.Generator().manual_seed(seed)
        coo = data.make_coo(cfg, gen, "cpu")
        st0 = hpf_initial_state(coo.n, coo.m, cfg["k"], cfg["priors"], gen,
                                "cpu")
        exact = {k: v.double() for k, v in st0.items()}
        below = st0
        numbers = {}
        for s in range(1, len(limits) + 1):
            exact = ref.hpf_step(exact, coo.u, coo.i, coo.y, cfg["k"],
                                 cfg["priors"])
            below = ref.hpf_step(below, coo.u, coo.i, coo.y, cfg["k"],
                                 cfg["priors"], low=low)
            gaps = compare.state_gaps(below, exact)
            numbers[compare.step_name(s)] = max(gaps.values())
        correct, failed = compare.judge(numbers, limits)
        assert not correct, numbers
        worst.append(min(numbers[k] / limits[k] for k in numbers))
    return worst


@pytest.mark.parametrize("cell", CELLS)
def test_control_fails_the_limits(small_root, cell):
    """The control fails every number of the cell's limits, on every
    seed."""
    assert min(control_ratios(small_root, cell)) > 1.0


def _digests(root):
    """{path: sha256} of BENCHMARK.json and every file of the benchmark's
    data directories under `root`."""
    paths = [os.path.join(root, "BENCHMARK.json")]
    for d in DATA_DIRS:
        base = os.path.join(root, manifest.DIR, d)
        paths += [os.path.join(base, f) for f in sorted(os.listdir(base))]
    out = {}
    for p in paths:
        with open(p, "rb") as f:
            out[p] = hashlib.sha256(f.read()).hexdigest()
    return out


def test_a_new_configuration_takes_new_files_only(tmp_path):
    """A K = 300 copy of the EchoNest configuration under a new name, with
    a CSR-sweep cell ("highest") and a bf16 hybrid cell, added to a
    checkout as a configuration file, two limits files and BENCHMARK.json
    entries alone: its small copy keeps K = 300 (another route), a sound
    run of each cell is correct, and each cell's control fails its limits.
    The limits are the K = 100 cells' of the same traffic, standing in for
    the card's readings that a real configuration brings; no file of the
    benchmark changes."""
    before = _digests(manifest.ROOT)
    new = tmp_path / "checkout"
    for d in DATA_DIRS:
        shutil.copytree(os.path.join(manifest.ROOT, manifest.DIR, d),
                        new / manifest.DIR / d)
    bench = json.loads(json.dumps(BENCH))
    base = manifest.config(BENCH, "echonest-hpf-k100")
    name = "echonest-hpf-k300"
    entry = {**[c for c in BENCH["configs"]
                if c["name"] == base["name"]][0],
             "name": name, "file": f"{manifest.DIR}/configs/{name}.json"}
    bench["configs"].append(entry)
    (new / entry["file"]).write_text(json.dumps({**base, "name": name,
                                                 "k": 300}))
    cells = []
    for traffic in ("segment", "hybrid-bf16"):
        cell = f"{name}.{traffic}"
        bench["workloads"].append({"name": cell, "config": name,
                                   "traffic": traffic, "chips": 1,
                                   "why": "a new configuration's cell"})
        shutil.copy(os.path.join(manifest.ROOT, manifest.DIR, "limits",
                                 f"echonest-hpf-k100.{traffic}.json"),
                    new / manifest.DIR / "limits" / f"{cell}.json")
        cells.append(cell)
    (new / "BENCHMARK.json").write_text(json.dumps(bench))
    small = make_small_root(str(new), str(tmp_path / "small"))
    assert manifest.config(manifest.load(small), name, small)["k"] == 300
    for cell in cells:
        result = execute(small, cell)
        assert result["correct"], (cell, result["checks"])
        assert min(control_ratios(small, cell)) > 1.0, cell
    assert _digests(manifest.ROOT) == before


@pytest.fixture
def card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the port's kernels run only there")
    return "cuda:0"


@pytest.mark.parametrize("cell", CELLS)
def test_sound_run_on_card(small_root, card, cell):
    result = execute(small_root, cell, device=card)
    assert result["correct"], result["checks"]
