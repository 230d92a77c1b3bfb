"""The port stands alone: it imports neither JAX nor the JAX package, and
its entry points run on the CUDA device unless the caller asks for the CPU.
The port's examples (``examples/torch_*.py``) are held to the import rule
too.

chip_smoke.py, the port's on-card smoke run, is held to the same rules and
must fail -- printing no result -- where there is no GPU or no checkout."""

import ast
import json
import os
import shutil
import subprocess
import sys
from pathlib import Path

import pytest

torch = pytest.importorskip("torch")

ROOT = Path(__file__).resolve().parents[1]
PORT = ROOT / "src" / "repro_torch"
MODULES = sorted(
    "repro_torch." + ".".join(p.relative_to(PORT).with_suffix("").parts)
    for p in PORT.rglob("*.py") if p.name != "__init__.py") + ["repro_torch"]


def _env():
    env = dict(os.environ)
    env["PYTHONPATH"] = str(ROOT / "src")
    return env


def test_port_modules_import_without_jax_or_reference():
    code = (
        "import importlib, json, sys\n"
        f"mods = {MODULES!r}\n"
        "for m in mods: importlib.import_module(m)\n"
        "bad = sorted(k for k in sys.modules if k == 'jax' or k.startswith('jax.')\n"
        "             or k == 'repro' or k.startswith('repro.'))\n"
        "print(json.dumps({'n': len(mods), 'bad': bad}))\n")
    out = subprocess.run([sys.executable, "-c", code], env=_env(), cwd=ROOT,
                         capture_output=True, text=True, timeout=300)
    assert out.returncode == 0, out.stderr
    res = json.loads(out.stdout.strip().splitlines()[-1])
    assert res["bad"] == [] and res["n"] == len(MODULES) >= 16


def test_the_lm_blocks_are_held_to_the_import_rule():
    """The recurrent and MoE blocks and their GLA engine are among the
    modules imported above and the sources parsed below."""
    for name in ("gla", "ssm", "rwkv", "moe"):
        assert f"repro_torch.models.{name}" in MODULES
        assert (PORT / "models" / f"{name}.py").is_file()


def _imported_names(path: Path):
    tree = ast.parse(path.read_text(), filename=str(path))
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            for alias in node.names:
                yield alias.name
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            yield node.module or ""


@pytest.mark.parametrize("path", sorted(PORT.rglob("*.py")) + [ROOT / "chip_smoke.py"]
                         + sorted((ROOT / "examples").glob("torch_*.py")),
                         ids=lambda p: str(p.relative_to(ROOT)))
def test_source_imports_neither_jax_nor_reference(path):
    for name in _imported_names(path):
        root = name.split(".")[0]
        assert root not in ("jax", "jaxlib", "repro"), f"{path}: imports {name}"
    text = path.read_text()
    assert "import jax" not in text and "from repro." not in text \
        and "import repro." not in text


def test_taylor_oracle_is_independent_of_the_jet_algebra():
    """core/taylor.py, the port's Taylor-mode oracle, shares nothing with
    the layer-level jet algebra it checks: no import of core/jet.py, by
    any spelling, and none of JAX or the JAX package."""
    path = PORT / "core" / "taylor.py"
    tree = ast.parse(path.read_text(), filename=str(path))
    names = []
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            names += [alias.name for alias in node.names]
        elif isinstance(node, ast.ImportFrom):
            base = "." * node.level + (node.module or "")
            names += [base] + [f"{base}.{alias.name}".replace("..", ".")
                               for alias in node.names]
    assert names, "no imports parsed"
    for name in names:
        assert name.split(".")[0] not in ("jax", "jaxlib", "repro"), name
        assert "core.jet" not in name and not name.startswith(".jet"), name


def test_entry_points_need_cuda_unless_cpu_is_asked_for(monkeypatch, tmp_path):
    from repro_torch import bridge, resolve_device
    from repro_torch.runtime import Trainer, TrainerConfig
    from repro_torch.core.modules import Dense
    from repro_torch.core.network import DenseMLP
    from repro_torch.core.ntp import init_mlp
    from repro_torch.serving import DerivativeServer
    from repro_torch.configs import get_arch
    from repro_torch.configs.base import ShapeCfg
    from repro_torch.data.tokens import synthetic_batch
    from repro_torch.models import decode_state_specs, init_model
    from repro_torch.models.attention import init_kv_cache
    from repro_torch.launch import dryrun

    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    lm = get_arch("qwen3-0.6b").reduced()
    net = DenseMLP(d_in=2, width=4, depth=2, d_out=1)
    gen = torch.Generator().manual_seed(0)
    params = net.init(gen, torch.float64, device="cpu")
    for call in (lambda: resolve_device(None),
                 lambda: init_mlp(gen, 2, 4, 2, 1),
                 lambda: net.init(gen, torch.float64),
                 lambda: Dense(2, 3).init(gen),
                 lambda: DerivativeServer(net, params, "ntp/cuda"),
                 lambda: DerivativeServer.from_checkpoint(str(tmp_path), net),
                 lambda: bridge.load_jax_checkpoint(str(tmp_path), net),
                 lambda: Trainer(TrainerConfig(ckpt_dir=str(tmp_path)), None, None),
                 lambda: bridge.params_from_numpy(bridge.params_to_numpy(params)),
                 lambda: init_model(lm, 0),
                 lambda: init_model(lm, 0, device="cuda"),
                 lambda: synthetic_batch(lm, ShapeCfg("t", 8, 1, "train"), 0),
                 lambda: init_kv_cache(lm, 1, 8, 2),
                 lambda: decode_state_specs(lm, 1, 8),
                 lambda: dryrun.main(["--arch", "qwen3-0.6b", "--shape", "decode_32k"])):
        with pytest.raises(RuntimeError, match="device='cpu'"):
            call()
    with DerivativeServer(net, params, "ntp/cuda", device="cpu") as srv:
        assert srv.device == torch.device("cpu")


def test_chip_smoke_fails_without_gpu_and_without_checkout(tmp_path):
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present: the no-GPU failure cannot show")
    out = subprocess.run([sys.executable, str(ROOT / "chip_smoke.py")],
                         cwd=ROOT, capture_output=True, text=True, timeout=300)
    assert out.returncode != 0 and '"ok"' not in out.stdout
    alone = tmp_path / "chip_smoke.py"
    shutil.copy(ROOT / "chip_smoke.py", alone)
    out = subprocess.run([sys.executable, str(alone)], cwd=tmp_path,
                         capture_output=True, text=True, timeout=300)
    assert out.returncode != 0 and '"ok"' not in out.stdout
