"""Nothing of the benchmark loads JAX or the JAX package; the reference loads nothing of the port."""
import ast
import os
import sys

from portbench import run as R
from portbench.tests import tiny as T


def _imports(path):
    tree = ast.parse(open(path).read())
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            yield from (a.name for a in node.names)
        elif isinstance(node, ast.ImportFrom) and node.module and node.level == 0:
            yield node.module


def _sources(sub=""):
    for d, _, files in os.walk(os.path.join(T.PORTBENCH, sub)):
        for f in files:
            if f.endswith(".py"):
                yield os.path.join(d, f)


def test_forbidden_names_compare_whole_top_level_names(monkeypatch):
    base = set(R.forbidden_modules())
    for name in ("fatezero_tpu_torch", "fatezero_tpu_torch.models", "jaxtyping", "flaxen"):
        monkeypatch.setitem(sys.modules, name, sys)
    assert set(R.forbidden_modules()) == base
    monkeypatch.setitem(sys.modules, "fatezero_tpu.ops", sys)
    monkeypatch.setitem(sys.modules, "jax.numpy", sys)
    assert {"fatezero_tpu", "jax"} <= set(R.forbidden_modules())


def test_no_source_imports_jax_or_the_jax_package():
    for path in _sources():
        if os.path.basename(path).startswith("test_"):
            continue
        for mod in _imports(path):
            assert mod.split(".")[0] not in R.FORBIDDEN, (path, mod)


def test_reference_imports_nothing_of_the_port():
    for path in _sources("reference"):
        for mod in _imports(path):
            assert mod.split(".")[0] not in R.FORBIDDEN | {"fatezero_tpu_torch"}, (path, mod)


def test_no_source_reads_the_tpu_records():
    for path in _sources():
        if os.path.basename(path).startswith("test_"):
            continue
        text = open(path).read()
        for name in ("BASELINE.json", "BENCH_r0", "MULTICHIP_r0", "bench.py\""):
            assert name not in text, (path, name)
