"""What the benchmark's modules import: never JAX, the JAX package or the
JAX bench (top-level names compared whole), and the reference's modules
nothing of the program either."""

import ast
import os

import pytest

import gsbench_tiny as tiny

FORBIDDEN = {"jax", "jaxlib", "flax", "gs2pc", "bench"}
# The reference's side: nothing of the program under test.
PLAIN = {"gsbench/reference.py", "gsbench/scene.py", "gsbench/trace.py",
         "gsbench/roofline.py", "control.py"}


def _modules():
    for dirpath, _, names in os.walk(tiny.BENCH):
        for n in sorted(names):
            if n.endswith(".py"):
                yield os.path.relpath(os.path.join(dirpath, n), tiny.BENCH)


def _top_names(rel):
    with open(os.path.join(tiny.BENCH, rel)) as fh:
        tree = ast.parse(fh.read())
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            yield from (a.name.split(".")[0] for a in node.names)
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            yield node.module.split(".")[0]


@pytest.mark.parametrize("rel", sorted(_modules()))
def test_no_module_imports_jax_or_the_jax_package(rel):
    assert not set(_top_names(rel)) & FORBIDDEN


@pytest.mark.parametrize("rel", sorted(PLAIN))
def test_reference_side_imports_nothing_of_the_program(rel):
    assert "gs2pc_torch" not in set(_top_names(rel))


def test_the_prefix_of_the_port_is_not_the_jax_package():
    assert "gs2pc_torch".split(".")[0] not in FORBIDDEN
