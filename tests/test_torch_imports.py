"""The PyTorch port stands alone: no file of `hsd_tpu_torch/`, and not
`chip_smoke.py`, imports jax, jaxlib or the JAX package, nor safetensors
or optax or orbax, which the card's machine does not have (the loader reads the
format itself; the oracle trains with torch.optim).

An AST scan rather than `sys.modules`: this process may have JAX loaded by
other tests or by site customization."""
import ast
import pathlib

import pytest

ROOT = pathlib.Path(__file__).resolve().parent.parent
FILES = sorted(str(p.relative_to(ROOT))
               for p in (ROOT / "hsd_tpu_torch").rglob("*.py"))
FILES.append("chip_smoke.py")
BANNED = ("jax", "jaxlib", "hsd_tpu", "safetensors", "optax", "orbax")


def _imported(tree: ast.AST):
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            for a in node.names:
                yield a.name
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            yield node.module or ""


def test_port_has_files():
    assert len(FILES) > 15, FILES


@pytest.mark.parametrize("rel", FILES)
def test_no_jax_import(rel):
    tree = ast.parse((ROOT / rel).read_text(), filename=rel)
    bad = [m for m in _imported(tree)
           if m.split(".")[0] in BANNED]
    assert not bad, f"{rel} imports {bad}"
