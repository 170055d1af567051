"""Nothing the benchmark runs imports JAX or the JAX package; the plain
reference imports nothing of the program either.  Top-level module names
are compared whole: ``infinistore_tpu_torch`` starts with the JAX
package's name and is allowed outside ``reference/``."""

import ast
import os

HERE = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
FORBIDDEN = {"jax", "jaxlib", "flax", "infinistore_tpu"}


def _imports(path):
    tree = ast.parse(open(path).read(), path)
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            for a in node.names:
                yield a.name.split(".")[0]
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            yield node.module.split(".")[0]
        elif (isinstance(node, ast.Call)
              and getattr(node.func, "attr", getattr(node.func, "id", ""))
              in ("import_module", "__import__") and node.args
              and isinstance(node.args[0], ast.Constant)):
            yield str(node.args[0].value).split(".")[0]


def _sources():
    for d, _, files in os.walk(HERE):
        for f in files:
            if f.endswith(".py"):
                yield os.path.join(d, f)


def test_no_jax_anywhere_in_the_benchmark():
    found = {(p, m) for p in _sources() for m in _imports(p)
             if m in FORBIDDEN}
    assert not found, found


def test_reference_imports_nothing_of_the_program():
    ref = os.path.join(HERE, "reference")
    found = {(p, m) for p in _sources() if p.startswith(ref)
             for m in _imports(p)
             if m in FORBIDDEN | {"infinistore_tpu_torch"}}
    assert not found, found


def test_the_check_sees_the_top_level_name_whole():
    assert "infinistore_tpu_torch".split(".")[0] not in FORBIDDEN
    assert "infinistore_tpu.serve".split(".")[0] in FORBIDDEN
