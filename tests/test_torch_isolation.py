"""The port stands alone: no module of ``repro_torch``, and not
``chip_smoke.py``, imports ``jax`` or anything of the JAX package
``repro``; and its entry points default to the card, raising where there
is none instead of continuing on the CPU."""
import ast
import os
import subprocess
import sys
from pathlib import Path

import pytest
import torch

ROOT = Path(__file__).resolve().parents[1]
PORT = ROOT / "src" / "repro_torch"
SOURCES = sorted(PORT.rglob("*.py")) + [ROOT / "chip_smoke.py"]
FORBIDDEN = ("jax", "jaxlib", "repro")


def _module_name(path: Path) -> str:
    rel = path.relative_to(ROOT / "src").with_suffix("")
    parts = rel.parts[:-1] if rel.name == "__init__" else rel.parts
    return ".".join(parts)


@pytest.mark.parametrize("path", SOURCES, ids=lambda p: str(p.relative_to(ROOT)))
def test_no_jax_or_repro_import_in_source(path):
    tree = ast.parse(path.read_text(), filename=str(path))
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            names = [a.name for a in node.names]
        elif isinstance(node, ast.ImportFrom):
            names = [node.module or ""]
        else:
            continue
        for name in names:
            assert name.split(".")[0] not in FORBIDDEN, \
                f"{path.name} imports {name}"


def test_every_module_imports_with_jax_and_repro_unimportable():
    modules = [_module_name(p) for p in sorted(PORT.rglob("*.py"))]
    script = f"""
import importlib, importlib.util, sys
class Block:
    def find_spec(self, name, path=None, target=None):
        if name.split(".")[0] in {FORBIDDEN!r}:
            raise ImportError("blocked: " + name)
sys.meta_path.insert(0, Block())
for m in {modules!r}:
    importlib.import_module(m)
spec = importlib.util.spec_from_file_location("chip_smoke", {str(ROOT / "chip_smoke.py")!r})
spec.loader.exec_module(importlib.util.module_from_spec(spec))
leaked = [m for m in sys.modules if m.split(".")[0] in {FORBIDDEN!r}]
assert not leaked, leaked
print("ok", len({modules!r}))
"""
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"))
    res = subprocess.run([sys.executable, "-c", script], env=env,
                         capture_output=True, text=True, timeout=120)
    assert res.returncode == 0, res.stderr
    assert res.stdout.startswith("ok")


def test_engine_defaults_to_the_card_and_raises_without_one(monkeypatch):
    from repro_torch.configs import get_reduced_config
    from repro_torch.launch import serve as launch_serve
    from repro_torch.models.model import init_params
    from repro_torch.serve.engine import ServeEngine

    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    cfg = get_reduced_config("qwen3_1_7b")
    params = init_params(cfg, torch.Generator().manual_seed(0), "cpu")
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        ServeEngine(cfg, params)
    args = launch_serve.parser().parse_args(["--reduced"])
    assert args.device == "cuda"
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        launch_serve.build_engine(args)
    # the explicit CPU path runs, and drains the pool
    eng = ServeEngine(cfg, params, device="cpu", max_batch=2, max_seq=24)
    args = launch_serve.parser().parse_args(
        ["--reduced", "--device", "cpu", "--requests", "2", "--prompt-len",
         "8", "--max-new", "3"])
    reqs, stats = launch_serve.serve(eng, args)
    assert stats["requests"] == 2 and stats["kv_blocks_in_use"] == 0
    assert all(len(r.output) == 3 for r in reqs)
