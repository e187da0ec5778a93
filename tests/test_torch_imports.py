"""The port stands alone: no module of src/repro_torch/ and not
chip_smoke.py imports jax, jaxlib or the JAX package `repro`."""
import ast
from pathlib import Path

import pytest

ROOT = Path(__file__).resolve().parents[1]
FILES = sorted((ROOT / "src" / "repro_torch").rglob("*.py")) + \
    [ROOT / "chip_smoke.py"]
FORBIDDEN = {"jax", "jaxlib", "repro"}


def _imported_roots(tree: ast.AST):
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            for alias in node.names:
                yield alias.name.split(".")[0]
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            yield node.module.split(".")[0]


def test_port_files_found():
    names = {p.relative_to(ROOT).as_posix() for p in FILES}
    assert "src/repro_torch/kernels/ops.py" in names
    assert "src/repro_torch/dist/backends/cuda.py" in names
    # the Section-V solvers, lasso and SSL slice
    for module in ("core/jacobi.py", "core/arma.py", "core/lasso.py",
                   "core/ssl.py", "dist/solvers.py",
                   "kernels/jacobi_step.py", "kernels/soft_threshold.py"):
        assert f"src/repro_torch/{module}" in names, module
    # the dense LM forward and the flash kernel
    for module in ("kernels/flash_attention.py", "configs/base.py",
                   "configs/__init__.py", "configs/starcoder2_3b.py",
                   "models/params.py", "models/layers.py", "models/model.py",
                   "models/steps.py"):
        assert f"src/repro_torch/{module}" in names, module
    # KV-cache decode, the serve launcher and the VLM backbone's preset
    for module in ("models/decode.py", "launch/__init__.py",
                   "launch/serve.py", "configs/qwen2_vl_2b.py"):
        assert f"src/repro_torch/{module}" in names, module
    # the sharded apply and the general partitions
    for module in ("dist/comm.py", "dist/sharded.py", "dist/partition.py",
                   "dist/backends/halo.py", "dist/backends/cuda_halo.py",
                   "dist/backends/allgather.py"):
        assert f"src/repro_torch/{module}" in names, module
    # the compressed exchange, the link faults and gossip
    for module in ("dist/quantize.py", "dist/faults.py", "dist/gossip.py"):
        assert f"src/repro_torch/{module}" in names, module
    # serving: the engine and the captured plan entries
    for module in ("serve/__init__.py", "serve/engine.py", "serve/request.py",
                   "serve/batching.py", "serve/clock.py", "serve/metrics.py",
                   "serve/loadgen.py", "dist/capture.py"):
        assert f"src/repro_torch/{module}" in names, module
    # training: the optimizer, checkpoints and the train launcher
    for module in ("optim/__init__.py", "optim/adamw.py", "ckpt/__init__.py",
                   "ckpt/checkpoint.py", "launch/train.py",
                   "data/pipeline.py"):
        assert f"src/repro_torch/{module}" in names, module
    assert len(names) >= 50


@pytest.mark.parametrize("path", FILES,
                         ids=lambda p: p.relative_to(ROOT).as_posix())
def test_no_jax_or_reference_import(path):
    tree = ast.parse(path.read_text(), filename=str(path))
    bad = sorted(set(_imported_roots(tree)) & FORBIDDEN)
    assert not bad, f"{path} imports {bad}"
