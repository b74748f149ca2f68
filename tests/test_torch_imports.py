"""Hygiene of the port: it imports neither JAX nor the JAX package, its
entry points default to the card (and raise without one), and
chip_smoke.py refuses to run without a card or outside the repo."""

import os
import shutil
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest
import torch

from fastecc_tpu_torch import fields, ntt, rs

torch.set_num_threads(1)

ROOT = Path(__file__).resolve().parent.parent


def _clean_env():
    env = dict(os.environ)
    env["PYTHONPATH"] = str(ROOT)
    return env


def test_port_imports_no_jax():
    code = (
        "import sys\n"
        "import fastecc_tpu_torch\n"
        "from fastecc_tpu_torch import fields, gf, ntt, packing, rs, "
        "interop\n"
        "from fastecc_tpu_torch.kernels import ntt_mfa, _build\n"
        "from fastecc_tpu_torch.utils import timer\n"
        "bad = sorted(m for m in sys.modules if m == 'jax' "
        "or m.startswith('jax.') or m == 'jaxlib' or m.startswith('jaxlib.') "
        "or m == 'fastecc_tpu' or m.startswith('fastecc_tpu.'))\n"
        "print('BAD', bad)\n"
        "sys.exit(1 if bad else 0)\n")
    out = subprocess.run([sys.executable, "-c", code], capture_output=True,
                         text=True, cwd=ROOT, env=_clean_env(), timeout=120)
    assert out.returncode == 0, out.stdout + out.stderr


def test_sources_name_no_jax():
    """No module of the port mentions an import of jax or fastecc_tpu."""
    for path in (ROOT / "fastecc_tpu_torch").rglob("*.py"):
        for line in path.read_text().splitlines():
            s = line.strip()
            if s.startswith(("import ", "from ")):
                mod = s.split()[1]
                assert not mod.startswith(("jax", "fastecc_tpu.")) and \
                    mod != "fastecc_tpu", (path, line)
    for path in [ROOT / "chip_smoke.py"]:
        assert "import jax" not in path.read_text()
        assert "from fastecc_tpu " not in path.read_text()


def test_numpy_input_defaults_to_the_card():
    """With no GPU and no explicit CPU request an entry point raises; it
    never carries on quietly on the CPU."""
    if torch.cuda.is_available():
        pytest.skip("this machine has a GPU: the call would run there")
    x = np.ones((8, 4), np.uint32)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        rs.encode_parity(x, fields.GF32)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        ntt.ntt_auto(x, fields.GF32)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        rs.encode_blocks(np.zeros((4, 64), np.uint8), fields.GF32)
    assert rs.encode_parity(x, fields.GF32, device="cpu").device.type == "cpu"


def _run_smoke(script: Path, cwd: Path):
    return subprocess.run([sys.executable, str(script)], capture_output=True,
                          text=True, cwd=cwd, timeout=120,
                          env={k: v for k, v in os.environ.items()
                               if k != "PYTHONPATH"})


def test_chip_smoke_fails_without_a_card():
    if torch.cuda.is_available():
        pytest.skip("this machine has a GPU")
    out = _run_smoke(ROOT / "chip_smoke.py", ROOT)
    assert out.returncode != 0
    assert '"ok": true' not in out.stdout


def test_chip_smoke_fails_alone(tmp_path):
    """In a directory that holds chip_smoke.py and nothing else of the
    repo it must fail (no card here, or no package there)."""
    shutil.copy(ROOT / "chip_smoke.py", tmp_path / "chip_smoke.py")
    out = _run_smoke(tmp_path / "chip_smoke.py", tmp_path)
    assert out.returncode != 0
    assert '"ok": true' not in out.stdout
