"""The port imports neither JAX (nor flax, optax or orbax) nor the JAX
package.

Checked two ways: importing pychain_tpu_torch in a fresh interpreter
leaves no ``jax`` or ``pychain_tpu`` module loaded, and no source file
of the port (nor chip_smoke.py, kernel_ablation.py or
tests/test_torch_card.py, which run on a card machine without JAX) names
either in an import statement or as a name.
Module names are compared whole: ``pychain_tpu`` is a prefix of
``pychain_tpu_torch``.
"""

import ast
import subprocess
import sys
from pathlib import Path

import pytest

ROOT = Path(__file__).resolve().parents[1]
FORBIDDEN = ("jax", "jaxlib", "flax", "optax", "orbax", "pychain_tpu")


def _forbidden(name: str) -> bool:
    return name.split(".")[0] in FORBIDDEN


def test_import_loads_no_jax():
    code = ("import sys, pychain_tpu_torch, pychain_tpu_torch.convert, "
            "pychain_tpu_torch.csrc.build, pychain_tpu_torch.ops.fact_kernels,"
            " pychain_tpu_torch.ops.stream_kernels, "
            "pychain_tpu_torch.ops.semiring, "
            "pychain_tpu_torch.ops.semiring_kernels, "
            "pychain_tpu_torch.ops.viterbi, "
            "pychain_tpu_torch.ops.viterbi_kernels, "
            "pychain_tpu_torch.decode, pychain_tpu_torch.simplefst, "
            "pychain_tpu_torch.graphs.builder, "
            "pychain_tpu_torch.tools.xl_roofline, pychain_tpu_torch.models, "
            "pychain_tpu_torch.utils.checkpoint, pychain_tpu_torch.data, "
            "pychain_tpu_torch.csrc.native, pychain_tpu_torch.utils.optim, "
            "pychain_tpu_torch.examples.train_corpus, "
            "pychain_tpu_torch.ops.fwdbwd, "
            "pychain_tpu_torch.tools.build_graphs, "
            "pychain_tpu_torch.examples.data_pipeline, "
            "pychain_tpu_torch.examples.train_tdnn, "
            "pychain_tpu_torch.examples.wav_to_train, "
            "pychain_tpu_torch.ops.dense_list, pychain_tpu_torch.utils.dist, "
            "pychain_tpu_torch.parallel, "
            "pychain_tpu_torch.parallel.data_parallel, "
            "pychain_tpu_torch.parallel.multihost, "
            "pychain_tpu_torch.parallel.model_parallel, "
            "pychain_tpu_torch.utils.mp, "
            "pychain_tpu_torch.tools.dryrun_multichip;"
            "print('\\n'.join(sorted(sys.modules)))")
    out = subprocess.run([sys.executable, "-c", code], cwd=ROOT,
                         capture_output=True, text=True, timeout=300,
                         check=True).stdout.split()
    assert "pychain_tpu_torch" in out
    assert [m for m in out if _forbidden(m)] == []


def _imports(path: Path):
    tree = ast.parse(path.read_text(), filename=str(path))
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            for alias in node.names:
                yield alias.name
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            yield node.module or ""
        elif isinstance(node, ast.Name):
            yield node.id


SOURCES = sorted((ROOT / "pychain_tpu_torch").rglob("*.py")) + [
    ROOT / "chip_smoke.py", ROOT / "kernel_ablation.py",
    ROOT / "tests" / "test_torch_card.py"]


@pytest.mark.parametrize("path", SOURCES,
                         ids=[str(p.relative_to(ROOT)) for p in SOURCES])
def test_sources_import_no_jax(path):
    bad = [m for m in _imports(path) if _forbidden(m)]
    assert bad == [], f"{path.relative_to(ROOT)} imports {bad}"


def test_forbidden_matches_whole_names():
    assert _forbidden("pychain_tpu.graphs") and _forbidden("jax.numpy")
    assert _forbidden("flax.linen") and _forbidden("orbax.checkpoint")
    assert not _forbidden("pychain_tpu_torch.graphs")
