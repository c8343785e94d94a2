"""The port stands alone: no module of ``longlive_torch`` nor
``chip_smoke.py`` imports JAX or the JAX package, and a CUDA request on a
host without CUDA fails loudly instead of falling back to the CPU."""

import ast
import os
from pathlib import Path

import pytest
import torch

ROOT = Path(__file__).resolve().parent.parent
FORBIDDEN = ("jax", "jaxlib", "longlive_tpu")


def _port_files():
    files = sorted((ROOT / "longlive_torch").rglob("*.py"))
    return files + [ROOT / "chip_smoke.py"]


def _imported_roots(tree):
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            for a in node.names:
                yield a.name.split(".")[0]
        elif isinstance(node, ast.ImportFrom) and node.level == 0 and node.module:
            yield node.module.split(".")[0]
        elif (isinstance(node, ast.Call) and getattr(node.func, "attr", None) == "import_module"
              and node.args and isinstance(node.args[0], ast.Constant)):
            yield str(node.args[0].value).split(".")[0]


def test_the_scan_covers_the_host_memory_module():
    """``utils/memory.py`` (pinned host copies, layer streaming) is among
    the files checked below."""
    assert ROOT / "longlive_torch" / "utils" / "memory.py" in _port_files()


def test_the_scan_covers_the_parallel_modules():
    """The multi-device modules (``parallel/``: the mesh and its rules, the
    two sequence-parallel forwards) are among the files checked below."""
    for name in ("__init__", "mesh", "sequence", "decode_sp"):
        assert ROOT / "longlive_torch" / "parallel" / f"{name}.py" in _port_files()


@pytest.mark.parametrize("path", _port_files(), ids=lambda p: str(p.relative_to(ROOT)))
def test_no_jax_imports(path):
    assert path.exists(), path
    roots = set(_imported_roots(ast.parse(path.read_text(), filename=str(path))))
    assert not roots & set(FORBIDDEN), f"{path} imports {sorted(roots & set(FORBIDDEN))}"


def _skip_if_cuda():
    if torch.cuda.is_available():
        pytest.skip("this host has CUDA; the no-CUDA error path cannot be shown here")


def test_cuda_request_without_cuda_raises():
    _skip_if_cuda()
    from longlive_torch.config import PipelineConfig, tiny_dit_config
    from longlive_torch.pipeline import CausalInferencePipeline
    from longlive_torch.utils.device import resolve_device

    with pytest.raises(RuntimeError, match="CUDA"):
        resolve_device("cuda")
    pc = PipelineConfig(num_frame_per_block=1, local_attn_size=4, sink_size=1)
    with pytest.raises(RuntimeError, match="CUDA"):
        CausalInferencePipeline(pc, {}, dit_config=tiny_dit_config(), device="cuda")


def test_cli_exits_cleanly_without_cuda(tmp_path):
    _skip_if_cuda()
    from longlive_torch import run_inference

    cfg = os.path.join(ROOT, "configs", "longlive_inference.yaml")
    with pytest.raises(SystemExit) as ei:
        run_inference.main(["--config_path", cfg, "--device", "cuda"])
    assert "CUDA is not available" in str(ei.value)


def test_init_distributed_cuda_without_cuda_raises():
    """Under torchrun a rank's card is cuda:$LOCAL_RANK; without CUDA the
    request fails, with no CPU or gloo fallback."""
    _skip_if_cuda()
    from longlive_torch.parallel.mesh import init_distributed

    with pytest.raises(RuntimeError, match="CUDA"):
        init_distributed("cuda")
