"""The PyTorch port stands alone: importing every module of it loads
neither JAX nor the JAX package, and no source file of it (nor
chip_smoke.py) imports them, or Pillow, OpenCV, transformers, tokenizers
or sentencepiece, which the card's machine does not have."""
import ast
import os
import subprocess
import sys
from pathlib import Path

import pytest

REPO = Path(__file__).resolve().parents[1]
FORBIDDEN = ("jax", "jaxlib", "flax", "consistentid_tpu")
NOT_ON_THE_CARD = ("PIL", "cv2", "transformers", "tokenizers",
                   "sentencepiece")


def test_import_loads_no_jax():
    code = (
        "import importlib, pkgutil, sys\n"
        "import consistentid_torch as pkg\n"
        "names = [m.name for m in pkgutil.walk_packages(pkg.__path__, "
        "'consistentid_torch.')]\n"
        "for name in names:\n"
        "    importlib.import_module(name)\n"
        "print(len(names))\n"
        f"bad = [m for m in sys.modules if m.split('.')[0] in {FORBIDDEN!r}]\n"
        "print(sorted(bad))\n")
    env = {k: v for k, v in os.environ.items() if k != "PYTHONSTARTUP"}
    out = subprocess.run([sys.executable, "-c", code], cwd=REPO, env=env,
                         capture_output=True, text=True, timeout=120)
    assert out.returncode == 0, out.stderr
    count, bad = out.stdout.strip().splitlines()[-2:]
    assert int(count) >= 25
    assert bad == "[]"


def _imported_roots(path):
    """The top-level package of every absolute import in the file, at any
    depth (imports inside functions too)."""
    tree = ast.parse(path.read_text(), filename=str(path))
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            yield from (a.name.split(".")[0] for a in node.names)
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            yield node.module.split(".")[0]


def test_no_source_imports_jax():
    files = sorted((REPO / "consistentid_torch").rglob("*.py"))
    files.append(REPO / "chip_smoke.py")
    for path in files:
        roots = set(_imported_roots(path))
        assert not roots & set(FORBIDDEN + NOT_ON_THE_CARD), (path, roots)


# the modules of the data/tensor-parallel and BiSeNet-training slice, held
# by the two tests above like every other module of the port
SLICE_13 = ("consistentid_torch.parallel", "consistentid_torch.parallel.mesh",
            "consistentid_torch.parallel.tensor_parallel",
            "consistentid_torch.parallel.launch",
            "consistentid_torch.training.bisenet_train",
            "consistentid_torch.apps.bisenet_tools")


def test_parallel_and_bisenet_modules_stand_alone():
    code = ("import importlib, sys\n"
            f"for name in {SLICE_13!r}:\n"
            "    importlib.import_module(name)\n"
            f"bad = [m for m in sys.modules if m.split('.')[0] in "
            f"{FORBIDDEN + NOT_ON_THE_CARD!r}]\n"
            "print(sorted(bad))\n")
    env = {k: v for k, v in os.environ.items() if k != "PYTHONSTARTUP"}
    out = subprocess.run([sys.executable, "-c", code], cwd=REPO, env=env,
                         capture_output=True, text=True, timeout=120)
    assert out.returncode == 0, out.stderr
    assert out.stdout.strip().splitlines()[-1] == "[]"


# the PyTorch twins of examples/*_demo.py run on the card's machine too
EXAMPLE_TWINS = ("minimal_demo_torch.py", "inpaint_demo_torch.py",
                 "controlnet_demo_torch.py")


@pytest.mark.parametrize("name", EXAMPLE_TWINS)
def test_example_twins_import_only_the_port(name):
    """Each twin imports the port, numpy, torch and the standard library:
    no JAX, no JAX package, no Pillow, no OpenCV (at any depth: imports
    inside functions too)."""
    roots = set(_imported_roots(REPO / "examples" / name))
    assert not roots & set(FORBIDDEN + NOT_ON_THE_CARD), roots
    assert "consistentid_torch" in roots
    assert roots - {"consistentid_torch", "numpy", "torch"} <= set(
        sys.stdlib_module_names), roots


def test_demo_imports_gradio_only_to_build_the_interface():
    """gradio is optional: consistentid_torch.apps.demo imports it inside
    build_interface and main, never at module level."""
    path = REPO / "consistentid_torch" / "apps" / "demo.py"
    tree = ast.parse(path.read_text(), filename=str(path))

    def imports(node):
        return {a.name for n in ast.walk(node) if isinstance(n, ast.Import)
                for a in n.names}

    assert [f.name for f in tree.body if isinstance(f, ast.FunctionDef)
            and "gradio" in imports(f)] == ["build_interface", "main"]
    assert "gradio" not in {a.name for n in tree.body
                            if isinstance(n, ast.Import) for a in n.names}
