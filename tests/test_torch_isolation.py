"""PyTorch port, isolation: ``repro_torch`` and ``chip_smoke.py`` import
neither JAX nor the JAX package, and the smoke script refuses to report a
result where it cannot run."""
import ast
import os
import subprocess
import sys
from pathlib import Path

import pytest

ROOT = Path(__file__).resolve().parents[1]
PORT = ROOT / "src" / "repro_torch"


def _imported_roots(path: Path) -> set[str]:
    roots = set()
    for node in ast.walk(ast.parse(path.read_text(), filename=str(path))):
        if isinstance(node, ast.Import):
            roots.update(a.name.split(".")[0] for a in node.names)
        elif isinstance(node, ast.ImportFrom) and node.module and \
                node.level == 0:
            roots.add(node.module.split(".")[0])
    return roots


def _port_files():
    return sorted(PORT.rglob("*.py")) + [ROOT / "chip_smoke.py"]


@pytest.mark.parametrize("path", _port_files(),
                         ids=lambda p: str(p.relative_to(ROOT)))
def test_no_jax_or_repro_import(path):
    roots = _imported_roots(path)
    assert not roots & {"jax", "jaxlib", "repro"}, roots


def test_port_imports_and_mines_with_jax_blocked():
    code = (
        "import sys\n"
        "for name in ('jax', 'jaxlib', 'repro'):\n"
        "    sys.modules[name] = None\n"
        "import repro_torch.core, repro_torch.interop\n"
        "import repro_torch.core.patterns, repro_torch.core.apps.mc\n"
        "import repro_torch.core.apps.psm\n"
        "import repro_torch.kernels.build\n"
        "import repro_torch.kernels.extend_fused.ops\n"
        "import repro_torch.kernels.flash_attention.ops\n"
        "import repro_torch.kernels.segsum.ops\n"
        "import repro_torch.launch.serve, repro_torch.launch.mesh\n"
        "import repro_torch.launch.mine, repro_torch.obs.validate\n"
        "import repro_torch.core.collectives\n"
        "from repro_torch.core import Miner, make_cf_app, mine_sharded\n"
        "from repro_torch.graph.generators import clique\n"
        "m = Miner(clique(6, device='cpu'), make_cf_app(4), device='cpu')\n"
        "assert m.run().count == 15 and m.run().count == 15\n"
        "from repro_torch.core import make_mc_app\n"
        "m = Miner(clique(5, device='cpu'), make_mc_app(4), device='cpu')\n"
        "assert list(m.run().p_map) == [0, 0, 0, 0, 0, 5]\n"
        "assert mine_sharded(clique(6, device='cpu'), make_cf_app(4),\n"
        "                    ((256, 128), (256, 128)), device='cpu')[0] == 15\n"
        "r = repro_torch.launch.mine.main(['--graph', 'clique:6', '--app',\n"
        "                                  '4-cf', '--device', 'cpu'])\n"
        "assert r.count == 15\n"
        "assert not any(k == 'jax' or k.startswith(('jax.', 'repro.'))\n"
        "               for k in sys.modules if sys.modules[k] is not None)\n")
    env = {**os.environ, "PYTHONPATH": str(ROOT / "src")}
    proc = subprocess.run([sys.executable, "-c", code], env=env,
                          capture_output=True, text=True, timeout=120)
    assert proc.returncode == 0, proc.stderr


def _run_smoke(cwd: Path) -> subprocess.CompletedProcess:
    env = {**os.environ, "CUDA_VISIBLE_DEVICES": ""}
    env.pop("PYTHONPATH", None)
    return subprocess.run([sys.executable, "chip_smoke.py"], cwd=cwd,
                          env=env, capture_output=True, text=True,
                          timeout=120)


def test_chip_smoke_fails_without_a_card():
    proc = _run_smoke(ROOT)
    assert proc.returncode != 0
    assert '"ok"' not in proc.stdout
    assert "no CUDA device" in proc.stderr


def test_chip_smoke_fails_without_the_repo(tmp_path):
    (tmp_path / "chip_smoke.py").write_text(
        (ROOT / "chip_smoke.py").read_text())
    proc = _run_smoke(tmp_path)
    assert proc.returncode != 0
    assert '"ok"' not in proc.stdout
    assert "package is not beside this script" in proc.stderr
