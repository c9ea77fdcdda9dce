"""Import hygiene of the port: ``repro_torch`` and ``chip_smoke.py`` import
``torch``, never ``jax`` and nothing of the reference package ``repro``;
importing the port builds no kernel."""
import ast
import json
import os
import pkgutil
import subprocess
import sys
from pathlib import Path

import pytest

ROOT = Path(__file__).resolve().parents[1]
SRC = ROOT / "src"


def _port_modules() -> list[str]:
    import repro_torch

    names = ["repro_torch"]
    for info in pkgutil.walk_packages(repro_torch.__path__, "repro_torch."):
        names.append(info.name)
    return names


def test_every_port_module_is_found():
    names = _port_modules()
    for must in ("repro_torch.kernels.flash_attention", "repro_torch.measure.run",
                 "repro_torch.comm.sync", "repro_torch.models.transformer",
                 "repro_torch.traces.format", "repro_torch.measure.__main__",
                 "repro_torch.kernels.rglru", "repro_torch.kernels.build",
                 "repro_torch.models.recurrent", "repro_torch.configs.recurrentgemma_2b",
                 "repro_torch.kernels.wkv6", "repro_torch.configs.rwkv6_16b",
                 "repro_torch.core.policies", "repro_torch.core.dag",
                 "repro_torch.core.simulator", "repro_torch.core.predictor",
                 "repro_torch.measure.model_vs_measured", "repro_torch.configs.gemma3_1b",
                 "repro_torch.core.xputil", "repro_torch.core.hardware",
                 "repro_torch.core.bucketsim", "repro_torch.core.analytical",
                 "repro_torch.core.het", "repro_torch.core.costmodel",
                 "repro_torch.core.archcost",
                 "repro_torch.traces.bundled", "repro_torch.core.workloads",
                 "repro_torch.core.scenarios", "repro_torch.core.resulttable",
                 "repro_torch.core.batched", "repro_torch.core.batched_torch",
                 "repro_torch.core.sweep", "repro_torch.sweep",
                 "repro_torch.traces.generate", "repro_torch.models.cnn",
                 "repro_torch.examples.table6_trace", "repro_torch.examples.trace_analysis",
                 "repro_torch.examples.dag_validation",
                 "repro_torch.launch.steps", "repro_torch.launch.serve",
                 "repro_torch.launch.train", "repro_torch.data.pipeline",
                 "repro_torch.checkpoint.ckpt", "repro_torch.examples.quickstart",
                 "repro_torch.models.encdec", "repro_torch.configs.whisper_tiny",
                 "repro_torch.configs.llama32_vision_90b",
                 "repro_torch.core.parallel", "repro_torch.core.service",
                 "repro_torch.core.agreement", "repro_torch.launch.serve_sweep"):
        assert must in names


def test_importing_every_port_module_loads_no_jax_and_no_repro():
    code = (
        "import importlib, json, sys\n"
        f"for name in {_port_modules()!r}:\n"
        "    if not name.endswith('__main__'):\n"
        "        importlib.import_module(name)\n"
        "from repro_torch.kernels import flash_attention as fa, rglru as rg, wkv6 as wk\n"
        "bad = sorted(m for m in sys.modules if m == 'jax' or m.startswith(('jax.', 'jaxlib'))\n"
        "             or m == 'repro' or m.startswith('repro.'))\n"
        "print(json.dumps({'bad': bad,\n"
        "                  'lib': fa._lib is None and rg._lib is None and wk._lib is None}))\n")
    env = dict(os.environ, PYTHONPATH=str(SRC))
    r = subprocess.run([sys.executable, "-c", code], env=env, capture_output=True, text=True,
                       timeout=120)
    assert r.returncode == 0, r.stderr[-2000:]
    out = json.loads(r.stdout.strip().splitlines()[-1])
    assert out == {"bad": [], "lib": True}


def _imported_roots(path: Path) -> set[str]:
    roots = set()
    for node in ast.walk(ast.parse(path.read_text())):
        if isinstance(node, ast.Import):
            roots.update(a.name.split(".")[0] for a in node.names)
        elif isinstance(node, ast.ImportFrom) and node.module and node.level == 0:
            roots.add(node.module.split(".")[0])
    return roots


@pytest.mark.parametrize("path", [ROOT / "chip_smoke.py",
                                  *sorted((SRC / "repro_torch").rglob("*.py"))],
                         ids=lambda p: str(p.relative_to(ROOT)))
def test_no_source_imports_jax_or_repro(path):
    roots = _imported_roots(path)
    assert not roots & {"jax", "jaxlib", "repro"}, roots
