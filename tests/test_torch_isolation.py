"""The port stands alone: no module of ``src/repro_torch/``, not
``chip_smoke.py`` and no script under ``tools/`` imports JAX, ``ml_dtypes``
or anything of the JAX package."""
import ast
import os
import subprocess
import sys
from pathlib import Path

import pytest

pytest.importorskip("torch")

ROOT = Path(__file__).resolve().parents[1]
PORT = ROOT / "src" / "repro_torch"
FORBIDDEN = ("jax", "jaxlib", "repro", "ml_dtypes")


def _port_files():
    files = (sorted(PORT.rglob("*.py")) + [ROOT / "chip_smoke.py"]
             + sorted((ROOT / "tools").glob("*.py")))
    return [f for f in files if f.exists()]


def _imported_roots(path: Path) -> set[str]:
    roots = set()
    for node in ast.walk(ast.parse(path.read_text(), filename=str(path))):
        if isinstance(node, ast.Import):
            roots.update(a.name.split(".")[0] for a in node.names)
        elif isinstance(node, ast.ImportFrom) and node.level == 0 and node.module:
            roots.add(node.module.split(".")[0])
        elif (isinstance(node, ast.Call) and getattr(node.func, "attr", None) == "import_module"
              and node.args and isinstance(node.args[0], ast.Constant)):
            roots.add(str(node.args[0].value).split(".")[0])
    return roots


def test_port_files_exist():
    names = {p.relative_to(PORT).as_posix() for p in PORT.rglob("*.py")}
    assert {"api.py", "convert.py", "core/engine.py", "core/driver.py", "core/packer.py",
            "kernels/mtgc_update.py", "kernels/build.py", "models/small.py",
            "kernels/quantize.py", "kernels/flash_attention.py", "kernels/rwkv6_scan.py",
            "models/config.py", "configs/__init__.py", "configs/qwen3_14b.py",
            "configs/rwkv6_1_6b.py", "models/layers.py", "models/rwkv6.py",
            "models/transformer.py", "launch/serve.py", "launch/train.py",
            "core/staleness.py", "core/faults.py", "core/compression.py",
            "core/population.py", "checkpoint/__init__.py", "checkpoint/checkpoint.py",
            "core/multilevel.py", "models/ssm.py", "kernels/ssm_scan.py",
            "configs/qwen2_5_32b.py", "configs/gemma3_27b.py", "configs/hymba_1_5b.py",
            "models/moe.py", "kernels/moe_dispatch.py", "configs/granite_moe_1b_a400m.py",
            "core/scaffold.py", "optim/__init__.py", "optim/optimizers.py",
            "optim/schedule.py", "sharding/__init__.py", "sharding/plan.py",
            "sharding/specs.py", "sharding/state.py", "launch/mesh.py", "configs/shapes.py",
            "configs/mixtral_8x22b.py"} <= names
    for src in ("mtgc_update", "quantize", "flash_attention", "rwkv6_scan", "rwkv6_scan_bwd",
                "ssm_scan", "moe_dispatch"):
        assert (PORT / "kernels" / "csrc" / f"{src}.cu").is_file()
    assert (ROOT / "chip_smoke.py").is_file()


@pytest.mark.parametrize("path", _port_files(), ids=lambda p: p.relative_to(ROOT).as_posix())
def test_no_jax_import(path):
    bad = _imported_roots(path) & set(FORBIDDEN)
    assert not bad, f"{path.relative_to(ROOT)} imports {sorted(bad)}"


def test_importing_the_port_loads_no_jax():
    code = ("import sys, repro_torch, repro_torch.api, repro_torch.convert, "
            "repro_torch.kernels.ops, repro_torch.data, repro_torch.configs, "
            "repro_torch.configs.qwen3_14b, repro_torch.configs.rwkv6_1_6b, "
            "repro_torch.models.transformer, repro_torch.launch.serve, "
            "repro_torch.launch.train, repro_torch.core.staleness, "
            "repro_torch.core.population, repro_torch.checkpoint, "
            "repro_torch.core.multilevel, repro_torch.models.ssm, "
            "repro_torch.kernels.ssm_scan, repro_torch.configs.qwen2_5_32b, "
            "repro_torch.configs.gemma3_27b, repro_torch.configs.hymba_1_5b, "
            "repro_torch.models.moe, repro_torch.kernels.moe_dispatch, "
            "repro_torch.configs.granite_moe_1b_a400m, repro_torch.core, "
            "repro_torch.core.scaffold, repro_torch.optim, repro_torch.sharding.plan, "
            "repro_torch.sharding.specs, repro_torch.sharding.state, "
            "repro_torch.launch.mesh, repro_torch.configs.shapes, "
            "repro_torch.configs.mixtral_8x22b; "
            "bad = sorted(m for m in sys.modules if m.split('.')[0] in "
            "('jax', 'jaxlib', 'repro', 'ml_dtypes')); print(bad); sys.exit(1 if bad else 0)")
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"))
    out = subprocess.run([sys.executable, "-c", code], env=env, capture_output=True,
                         text=True, timeout=120)
    assert out.returncode == 0, out.stdout + out.stderr
