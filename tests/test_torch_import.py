"""The port imports no JAX, and it has no hidden fallback: asking for CUDA
without a card, a failed kernel build and a kernel launcher handed CPU
tensors all raise, and chip_smoke.py fails without a card."""

import os
import shutil
import subprocess
import sys

import numpy as np
import pytest
import torch

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

BLOCK_JAX = r"""
import importlib.abc, sys

class _Block(importlib.abc.MetaPathFinder):
    def find_spec(self, name, path=None, target=None):
        banned = ("jax", "jaxlib", "arachne_tpu.ops", "arachne_tpu.parallel",
                  "arachne_tpu.cli")
        if any(name == b or name.startswith(b + ".") for b in banned):
            raise ImportError("blocked: " + name)
        return None

sys.meta_path.insert(0, _Block())
import arachne_tpu_torch, arachne_tpu_torch.cli, arachne_tpu_torch.device
import arachne_tpu_torch.ops.engine, arachne_tpu_torch.ops.build, arachne_tpu_torch.measure
import arachne_tpu_torch.ops.fm_rank, arachne_tpu_torch.ops.fm_seed
import arachne_tpu_torch.ops.cuda_rank, arachne_tpu_torch.ops.cuda_seed
import arachne_tpu_torch.seeding_bench
import chip_smoke
assert "jax" not in sys.modules
assert not any(m.startswith("arachne_tpu.ops") for m in sys.modules)
print("ok")
"""


def _env():
    env = dict(os.environ)
    env["PYTHONPATH"] = ROOT + os.pathsep + env.get("PYTHONPATH", "")
    return env


def test_port_imports_without_jax():
    proc = subprocess.run(
        [sys.executable, "-c", BLOCK_JAX], cwd=ROOT, env=_env(),
        capture_output=True, text=True, timeout=120,
    )
    assert proc.returncode == 0, proc.stderr
    assert proc.stdout.strip() == "ok"


def test_cuda_device_raises_without_a_card(monkeypatch):
    from arachne_tpu_torch.device import resolve_device

    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="cuda"):
        resolve_device("cuda")
    assert resolve_device("cpu") == torch.device("cpu")


def test_align_engine_cuda_raises_without_a_card(monkeypatch, tmp_path):
    from arachne_tpu_torch import cli

    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="cuda"):
        cli.main(["align", "--engine", "cuda", "--sam", str(tmp_path / "out"),
                  "ref.fa", "r1.fq", "r2.fq"])


def test_failed_build_raises(monkeypatch, tmp_path):
    from arachne_tpu_torch.ops import build

    monkeypatch.setattr(build, "_lib", None)
    monkeypatch.setattr(build, "build_dir", lambda: str(tmp_path / "kernels"))
    monkeypatch.setattr(build, "nvcc_path", lambda: None)
    with pytest.raises(RuntimeError, match="nvcc"):
        build.get_lib()
    # a compiler that exists but fails is an error too, never a fallback
    monkeypatch.setattr(build, "nvcc_path", lambda: shutil.which("false"))
    with pytest.raises(RuntimeError, match="nvcc failed"):
        build.get_lib()


def test_launchers_refuse_cpu_tensors():
    from arachne_tpu_torch.ops.cuda_extend import extend_cuda
    from arachne_tpu_torch.ops.cuda_global import global_score_cuda, traceback_cuda
    from arachne_tpu_torch.ops.cuda_local import local_cuda
    from arachne_tpu_torch.ops.cuda_rank import rank_cuda
    from arachne_tpu_torch.ops.cuda_seed import pass3_cuda, smem_pass_cuda
    from arachne_tpu_torch.ops.fm_rank import DeviceFMIndex

    qs = torch.zeros((2, 32), dtype=torch.int8)
    ts = torch.zeros((2, 64), dtype=torch.int8)
    v = torch.ones(2, dtype=torch.int32)
    mat = torch.zeros((5, 5), dtype=torch.int32)
    gaps = dict(o_del=6, e_del=1, o_ins=6, e_ins=1)
    fm = DeviceFMIndex(occ=torch.zeros((2, 4), dtype=torch.int32),
                       words=torch.zeros(8, dtype=torch.int32),
                       L2=torch.zeros(5, dtype=torch.int32), primary=1, seq_len=128, l_pac=64)
    launchers = (extend_cuda, local_cuda, global_score_cuda, traceback_cuda, rank_cuda,
                 smem_pass_cuda, pass3_cuda)
    before = [f.launches for f in launchers]
    with pytest.raises(ValueError):
        extend_cuda(qs, ts, v, v, v, v, mat, zdrop=100, **gaps)
    with pytest.raises(ValueError):
        local_cuda(qs, ts, v, v, v, v, mat, max_mat=1, **gaps)
    with pytest.raises(ValueError):
        global_score_cuda(qs, ts, v, v, v, mat, **gaps)
    with pytest.raises(ValueError):
        traceback_cuda(torch.zeros((2, 64, 32), dtype=torch.uint8), v, v, v, max_steps=96)
    with pytest.raises(ValueError):
        rank_cuda(fm, v)
    with pytest.raises(ValueError):
        smem_pass_cuda(fm, qs, v, v, v, False, 12, 48)
    with pytest.raises(ValueError):
        pass3_cuda(fm, qs, v, 19, 20, 48)
    assert [f.launches for f in launchers] == before


def test_block_threads_limit():
    from arachne_tpu_torch.ops.build import block_threads

    assert block_threads(192) == 192 and block_threads(100) == 128
    with pytest.raises(ValueError):
        block_threads(1025)


@pytest.mark.parametrize("isolated", [False, True])
def test_chip_smoke_fails_without_a_card(isolated, tmp_path):
    """On a host without CUDA the smoke test exits non-zero and prints no
    result line; so it does in a directory holding nothing else of the
    repository."""
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    cwd = ROOT
    env = _env()
    if isolated:
        shutil.copy(os.path.join(ROOT, "chip_smoke.py"), tmp_path)
        cwd = str(tmp_path)
        env.pop("PYTHONPATH")
    proc = subprocess.run(
        [sys.executable, "chip_smoke.py"], cwd=cwd, env=env,
        capture_output=True, text=True, timeout=120,
    )
    assert proc.returncode != 0
    assert '"ok"' not in proc.stdout


def test_chip_smoke_refuses_more_than_one_card(monkeypatch, capsys):
    """Its result line reports one card, so it runs only where one is
    visible."""
    monkeypatch.syspath_prepend(ROOT)
    import chip_smoke

    monkeypatch.setattr(torch.cuda, "is_available", lambda: True)
    monkeypatch.setattr(torch.cuda, "device_count", lambda: 2)
    assert chip_smoke.main() != 0
    out = capsys.readouterr()
    assert '"ok"' not in out.out and "2 cards visible" in out.err


def test_probe_reports_without_a_card(monkeypatch):
    from arachne_tpu_torch.device import probe

    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    info = probe()
    assert info["cuda_available"] is False and info["device_name"] is None
    assert info["torch"] == torch.__version__
    assert np.all([k in info for k in ("nvcc", "nvidia_smi", "capability")])
