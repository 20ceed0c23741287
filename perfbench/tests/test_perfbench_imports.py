"""No module of the benchmark imports JAX or the JAX package (top-level
names compared whole: `hsd_tpu_torch` is not `hsd_tpu`), and the plain
reference imports nothing of the program."""
import ast
from pathlib import Path

PKG = Path(__file__).resolve().parents[1]
FORBIDDEN = {"jax", "jaxlib", "flax", "hsd_tpu"}


def imported(path: Path):
    """Top-level names of every import in a file (relative imports: '.')."""
    out = set()
    for node in ast.walk(ast.parse(path.read_text(), str(path))):
        if isinstance(node, ast.Import):
            out |= {a.name.split(".")[0] for a in node.names}
        elif isinstance(node, ast.ImportFrom):
            out.add("." if node.level else node.module.split(".")[0])
    return out


def test_no_module_imports_jax_or_the_jax_package():
    files = sorted(PKG.rglob("*.py"))
    assert len(files) > 20
    bad = {str(f.relative_to(PKG)): imported(f) & FORBIDDEN for f in files}
    assert not {k: v for k, v in bad.items() if v}


def test_the_reference_imports_nothing_of_the_program():
    for f in (PKG / "reference").glob("*.py"):
        assert "hsd_tpu_torch" not in imported(f), f


def test_names_are_compared_whole():
    src = "import hsd_tpu_torch.ops\nfrom hsd_tpu_torch import x\n"
    tree = ast.parse(src)
    names = {n.names[0].name.split(".")[0] if isinstance(n, ast.Import)
             else n.module.split(".")[0] for n in tree.body}
    assert names == {"hsd_tpu_torch"} and not names & FORBIDDEN


def _run_module():
    import importlib.util
    spec = importlib.util.spec_from_file_location("perfbench_run",
                                                  PKG / "run.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def test_run_flags_jax_loaded_by_whole_name(monkeypatch):
    import sys
    run = _run_module()
    monkeypatch.setitem(sys.modules, "hsd_tpu_torch_fake", sys)
    assert run.loaded_forbidden() == []
    monkeypatch.setitem(sys.modules, "jax.numpy_fake", sys)
    assert run.loaded_forbidden() == ["jax"]


def test_run_refuses_without_the_program_or_a_card(tmp_path):
    import shutil
    import subprocess
    import sys
    shutil.copy(PKG.parent / "BENCHMARK.json", tmp_path)
    shutil.copytree(PKG, tmp_path / "perfbench",
                    ignore=shutil.ignore_patterns("__pycache__"))
    args = [sys.executable, "perfbench/run.py", "--workload",
            "qwen2.5-14b.gsm8k", "--seed", "1", "--seconds", "1"]
    alone = subprocess.run(args, cwd=tmp_path, capture_output=True,
                           text=True, timeout=120)
    assert alone.returncode != 0 and alone.stdout == ""
    assert "hsd_tpu_torch" in alone.stderr
    # with the program beside it, a machine with no card stops it
    (tmp_path / "hsd_tpu_torch").symlink_to(PKG.parent / "hsd_tpu_torch")
    nocard = subprocess.run(args, cwd=tmp_path, capture_output=True,
                            text=True, timeout=120)
    assert nocard.returncode != 0 and nocard.stdout == ""
    assert "no CUDA device" in nocard.stderr
