"""The port stands alone: no module under src/repro_torch/, and not
chip_smoke.py, imports ``jax`` or anything of the reference package
``repro`` — checked statically (AST) and by importing every port module in
a subprocess where ``jax`` and ``repro`` cannot be imported.
"""
import ast
import pathlib
import subprocess
import sys

import pytest

pytest.importorskip("torch")

ROOT = pathlib.Path(__file__).resolve().parents[1]
PORT = ROOT / "src" / "repro_torch"
FORBIDDEN = ("jax", "jaxlib", "repro")


def _port_files():
    return sorted(PORT.rglob("*.py")) + [ROOT / "chip_smoke.py"]


def _module_names():
    return sorted(
        ".".join(p.relative_to(ROOT / "src").with_suffix("").parts)
        .removesuffix(".__init__")
        for p in PORT.rglob("*.py"))


def _imported_roots(path):
    tree = ast.parse(path.read_text(), filename=str(path))
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            for alias in node.names:
                yield alias.name.split(".")[0], node.lineno
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            yield node.module.split(".")[0], node.lineno


def test_port_sources_import_no_jax_or_reference():
    files = _port_files()
    assert len(files) > 20 and (ROOT / "chip_smoke.py").exists()
    bad = [f"{p.relative_to(ROOT)}:{line} imports {root}"
           for p in files for root, line in _imported_roots(p)
           if root in FORBIDDEN]
    assert not bad, bad


def test_every_port_module_imports_without_jax():
    names = _module_names()
    assert "repro_torch.kernels.fused_gemm" in names
    code = (
        "import sys\n"
        "sys.modules['jax'] = None\n"
        "sys.modules['jaxlib'] = None\n"
        "sys.modules['repro'] = None\n"
        f"sys.path.insert(0, {str(ROOT / 'src')!r})\n"
        "import importlib\n"
        f"for name in {names!r}:\n"
        "    importlib.import_module(name)\n"
        "assert not any(m.startswith('repro.') for m in sys.modules)\n"
        f"print('ok', {len(names)})\n")
    res = subprocess.run([sys.executable, "-c", code], capture_output=True,
                         text=True, timeout=120, cwd=ROOT)
    assert res.returncode == 0, res.stderr
    assert res.stdout.startswith("ok")


def test_distribution_modules_are_covered():
    """The distribution modules, and those MoE under a mesh runs through,
    are among those imported without jax."""
    names = _module_names()
    for name in ("repro_torch.dist", "repro_torch.dist.sharding",
                 "repro_torch.dist.shard_gemm",
                 "repro_torch.dist.collectives", "repro_torch.launch.mesh",
                 "repro_torch.quant.qmatmul", "repro_torch.models.moe",
                 "repro_torch.models.lm", "repro_torch.serve.engine",
                 "repro_torch.launch.steps", "repro_torch.launch.train",
                 "repro_torch.launch.serve", "repro_torch.tune.runner"):
        assert name in names
        path = PORT.parent.joinpath(*name.split(".")).with_suffix(".py")
        if not path.exists():
            path = PORT.parent.joinpath(*name.split("."), "__init__.py")
        assert not [r for r, _ in _imported_roots(path) if r in FORBIDDEN]


def test_training_modules_are_covered():
    """The training modules (under a mesh since the mesh slice) are among
    those imported without jax."""
    names = _module_names()
    for name in ("repro_torch.launch.steps", "repro_torch.launch.train",
                 "repro_torch.train.loop", "repro_torch.train.optim",
                 "repro_torch.train.checkpoint", "repro_torch.bridge",
                 "repro_torch.configs"):
        assert name in names
        path = PORT.parent.joinpath(*name.split(".")).with_suffix(".py")
        if not path.exists():
            path = PORT.parent.joinpath(*name.split("."), "__init__.py")
        assert not [r for r, _ in _imported_roots(path) if r in FORBIDDEN]


@pytest.mark.parametrize("body", ["_torch_dist_ranks.py",
                                  "_torch_train_mesh_ranks.py"])
def test_rank_bodies_import_no_jax_or_reference(body):
    """The ranks of the mesh tests run the port alone: their bodies import
    nothing of jax or the reference."""
    path = ROOT / "tests" / body
    roots = [r for r, _ in _imported_roots(path)]
    assert "repro_torch" in roots
    assert not [r for r in roots if r in FORBIDDEN], body
