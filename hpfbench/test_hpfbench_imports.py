"""No module of the benchmark imports JAX or the JAX package, compared by
whole top-level names (so the port, `hgaprec_tpu_torch`, passes), and the
plain references import nothing of the port."""

import ast
import glob
import os
import sys

import pytest

HERE = os.path.dirname(os.path.abspath(__file__))
FORBIDDEN = {"jax", "jaxlib", "flax", "hgaprec_tpu"}
MODULES = sorted(glob.glob(os.path.join(HERE, "**", "*.py"), recursive=True))


def top_level_imports(path):
    with open(path) as f:
        tree = ast.parse(f.read(), path)
    names = set()
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            names.update(a.name.split(".")[0] for a in node.names)
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            names.add(node.module.split(".")[0])
    return names


@pytest.mark.parametrize("path", MODULES, ids=lambda p: os.path.relpath(
    p, HERE))
def test_no_jax(path):
    assert not top_level_imports(path) & FORBIDDEN


def test_the_check_compares_whole_names():
    assert "hgaprec_tpu_torch".split(".")[0] not in FORBIDDEN
    assert "hgaprec_tpu.ops".split(".")[0] in FORBIDDEN


@pytest.mark.parametrize("path", sorted(glob.glob(
    os.path.join(HERE, "refs", "*.py"))) + [os.path.join(HERE,
                                                          "state_init.py")],
    ids=os.path.basename)
def test_reference_imports_nothing_of_the_port(path):
    names = top_level_imports(path)
    assert "hgaprec_tpu_torch" not in names
    assert names <= {"__future__", "typing", "torch", "numpy", "hpfbench"}
    # and what it takes from the benchmark is the reference alone
    with open(path) as f:
        tree = ast.parse(f.read())
    for node in ast.walk(tree):
        if isinstance(node, ast.ImportFrom) and node.module and \
                node.module.startswith("hpfbench"):
            assert node.module == "hpfbench.refs.hpf"


def test_run_guard_finds_forbidden_modules(monkeypatch):
    from hpfbench import run
    monkeypatch.setitem(sys.modules, "jaxlib.xla_client", object())
    assert run.forbidden_modules() == ["jaxlib"]
    with pytest.raises(run.Failed):
        run.guard("test")
    monkeypatch.delitem(sys.modules, "jaxlib.xla_client")
    monkeypatch.setitem(sys.modules, "hgaprec_tpu_torch_like", object())
    assert "hgaprec_tpu" not in run.forbidden_modules()
