"""Nothing under portbench/ imports JAX or the JAX package, and the plain
reference imports nothing of the program: the top-level name of every
import, compared whole."""

import ast

from conftest import BENCH_DIR

FORBIDDEN = {"jax", "jaxlib", "flax", "bls12_381_tpu"}
PROGRAM = "bls12_381_torch"
REFERENCE_MAY_IMPORT = {"__future__", "functools", "hashlib", "numpy"}


def imports(path):
    """Top-level names of the absolute imports of a file; relative imports
    as "."."""
    names = set()
    for node in ast.walk(ast.parse(path.read_text(), str(path))):
        if isinstance(node, ast.Import):
            names |= {a.name.split(".")[0] for a in node.names}
        elif isinstance(node, ast.ImportFrom):
            names.add("." if node.level else node.module.split(".")[0])
    return names


def sources():
    return sorted(BENCH_DIR.rglob("*.py"))


def test_no_jax_anywhere():
    found = {str(p): imports(p) & FORBIDDEN for p in sources()}
    assert not any(found.values()), found
    # whole names: the program's name begins with the JAX package's
    assert PROGRAM.split("_")[:2] == "bls12_381_tpu".split("_")[:2]


def test_reference_imports_nothing_of_the_program():
    for path in sorted((BENCH_DIR / "reference").glob("*.py")):
        names = imports(path)
        assert PROGRAM not in names, path
        assert names <= REFERENCE_MAY_IMPORT | {"."}, (path, names)


def test_the_check_sees_whole_names():
    import harness
    import sys

    sys.modules.setdefault("jax_like_but_not_jax", sys)
    try:
        assert "jax_like_but_not_jax" not in harness.forbidden_modules()
    finally:
        del sys.modules["jax_like_but_not_jax"]
    assert PROGRAM not in harness.FORBIDDEN
