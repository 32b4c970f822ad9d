"""The port stands alone: no module of ``src/repro_torch``, not
``chip_smoke.py``, no script of ``tools/`` and no port example
(``examples/torch_*.py``) imports ``jax`` or the
reference package ``repro`` (an AST scan), every kernel wrapper carries a
launch count, and each CUDA source names the TPU kernel it replaces and
its bound."""

import ast
from pathlib import Path

import pytest

ROOT = Path(__file__).resolve().parent.parent
PORT = ROOT / "src" / "repro_torch"
FILES = (sorted(PORT.rglob("*.py")) + [ROOT / "chip_smoke.py"]
         + sorted((ROOT / "tools").glob("*.py"))
         + sorted((ROOT / "examples").glob("torch_*.py")))


def _imported_roots(path: Path):
    tree = ast.parse(path.read_text(), filename=str(path))
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            for a in node.names:
                yield a.name.split(".")[0], node.lineno
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            yield (node.module or "").split(".")[0], node.lineno
        elif isinstance(node, ast.Call) and getattr(
                node.func, "id", None) == "__import__" and node.args \
                and isinstance(node.args[0], ast.Constant):
            yield str(node.args[0].value).split(".")[0], node.lineno


@pytest.mark.parametrize("path", FILES, ids=lambda p: str(p.relative_to(ROOT)))
def test_no_jax_or_reference_imports(path):
    assert path.exists(), path
    bad = [(root, line) for root, line in _imported_roots(path)
           if root in ("jax", "jaxlib", "repro")]
    assert not bad, f"{path.relative_to(ROOT)} imports {bad}"


def test_scan_covers_the_package():
    names = {p.relative_to(PORT).as_posix() for p in PORT.rglob("*.py")}
    for want in ("core/facade.py", "kernels/similarity.py",
                 "kernels/predict.py", "serving/engine.py",
                 "launch/serve.py", "state.py", "device.py",
                 "index/clustered.py", "index/kmeans.py",
                 "kernels/cluster.py", "kernels/select.py",
                 "kernels/rerank.py", "index/item_index.py",
                 "kernels/support.py", "kernels/flash_attention.py",
                 "models/common.py", "models/transformer.py",
                 "configs/registry.py", "configs/llama3_2_1b.py",
                 "configs/codeqwen1_5_7b.py", "configs/qwen1_5_110b.py",
                 "launch/steps.py", "data/batches.py",
                 "kernels/embedding_bag.py", "kernels/ops.py",
                 "models/embedding.py", "models/dlrm.py", "models/fm.py",
                 "models/xdeepfm.py", "configs/dlrm_mlperf.py",
                 "configs/fm.py", "configs/xdeepfm.py",
                 "core/cf_model.py", "core/slope_one.py",
                 "configs/cf_movielens.py", "models/egnn.py",
                 "data/graph.py", "configs/egnn.py", "launch/dryrun.py",
                 "launch/op_cost.py", "analysis/precision.py",
                 "analysis/retrace.py", "analysis/findings.py"):
        assert want in names


@pytest.mark.parametrize("name,replaces,wrappers", [
    ("similarity", "repro/kernels/similarity.py", ["fused_similarity"]),
    ("predict", "repro/kernels/predict.py", ["fused_tile_predict"]),
    ("cluster", "repro/kernels/cluster.py", ["fused_centroid_distances"]),
    ("select", "repro/kernels/select.py", ["fused_scan_topm",
                                           "select_topm"]),
    ("rerank", "repro/kernels/rerank.py", ["fused_rerank_scores"]),
    ("support", "repro/kernels/support.py", ["fused_support_scores"]),
    ("flash_attention", "repro/kernels/flash_attention.py",
     ["flash_attention"]),
    ("embedding_bag", "repro/kernels/embedding_bag.py", ["embedding_bag"]),
])
def test_kernel_sources_and_wrappers(name, replaces, wrappers):
    import importlib
    from repro_torch.kernels import _build
    src = (PORT / "csrc" / f"{name}.cu").read_text()
    assert replaces in src and "Bound." in src
    assert 'extern "C"' in src and "cudaGetLastError" in src
    assert name in _build.KERNELS
    mod = importlib.import_module(f"repro_torch.kernels.{name}")
    for wrapper in wrappers:
        assert isinstance(getattr(mod, wrapper).launches, int)
