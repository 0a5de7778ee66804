"""The port imports neither JAX nor anything of the JAX package
(``arachne_tpu``), and it has no hidden fallback: asking for CUDA without a
card, a failed kernel build and a kernel launcher handed CPU tensors all
raise, and chip_smoke.py fails without a card."""

import ast
import hashlib
import os
import shutil
import subprocess
import sys

import numpy as np
import pytest
import torch

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

BLOCK_JAX = r"""
import importlib, importlib.abc, pkgutil, sys

class _Block(importlib.abc.MetaPathFinder):
    def find_spec(self, name, path=None, target=None):
        # arachne_tpu_torch shares the prefix: match whole package names
        banned = ("jax", "jaxlib", "arachne_tpu")
        if any(name == b or name.startswith(b + ".") for b in banned):
            raise ImportError("blocked: " + name)
        return None

sys.meta_path.insert(0, _Block())
import arachne_tpu_torch
names = [m.name for m in pkgutil.walk_packages(arachne_tpu_torch.__path__, "arachne_tpu_torch.")]
for name in names:
    importlib.import_module(name)
import chip_smoke
assert not any(m in ("jax", "arachne_tpu") or m.startswith(("jax.", "arachne_tpu."))
               for m in sys.modules)
print("ok", len(names))
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
    word, n = proc.stdout.split()
    assert word == "ok" and int(n) >= 60   # every module of the port was imported


def port_sources():
    pkg = os.path.join(ROOT, "arachne_tpu_torch")
    files = [os.path.join(ROOT, "chip_smoke.py")]
    for d, _, names in os.walk(pkg):
        files += [os.path.join(d, f) for f in names if f.endswith(".py")]
    return files


def test_no_port_file_names_the_jax_package_in_an_import():
    """Not even in a function body, which the blocked import above only
    reaches when the function runs."""
    offenders = []
    for path in port_sources():
        with open(path) as fh:
            tree = ast.parse(fh.read(), path)
        for node in ast.walk(tree):
            if isinstance(node, ast.Import):
                mods = [a.name for a in node.names]
            elif isinstance(node, ast.ImportFrom) and node.level == 0:
                mods = [node.module or ""]
            else:
                continue
            for m in mods:
                if m.split(".")[0] in ("arachne_tpu", "jax", "jaxlib"):
                    offenders.append(f"{os.path.relpath(path, ROOT)}:{node.lineno} {m}")
    assert len(port_sources()) >= 60
    assert offenders == []


def _digest(path):
    with open(path, "rb") as fh:
        return os.stat(path).st_mtime_ns, hashlib.sha256(fh.read()).hexdigest()


def test_native_build_leaves_the_jax_package_untouched(monkeypatch, tmp_path):
    """The port builds its own copy of the C++ host library into build/,
    never into a package directory; the JAX package's tracked library keeps
    its bytes and its mtime."""
    from arachne_tpu_torch import native

    ref_dir = os.path.join(ROOT, "arachne_tpu", "native")
    ref_lib = os.path.join(ref_dir, "_arachne_native.so")
    before = _digest(ref_lib), sorted(os.listdir(ref_dir))
    assert native.lib_path().startswith(os.path.join(ROOT, "build", "arachne_tpu_torch", "native"))
    if shutil.which("g++") is None:
        pytest.skip("no g++ to build the native library with")
    # a fresh build, into a directory of this test's own
    fresh = str(tmp_path / "native" / "_arachne_native.so")
    monkeypatch.setattr(native, "lib_path", lambda: fresh)
    monkeypatch.setattr(native, "_lib", None)
    monkeypatch.setattr(native, "_tried", False)
    lib = native.get_lib()
    assert lib is not None and lib._name == fresh
    assert os.listdir(tmp_path / "native") == ["_arachne_native.so"]   # no temporary left
    assert not any(f.endswith(".so") for f in os.listdir(os.path.join(ROOT, "arachne_tpu_torch", "native")))
    assert (_digest(ref_lib), sorted(os.listdir(ref_dir))) == before


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
    monkeypatch.setattr(build, "build_dir", lambda csrc=None: str(tmp_path / "kernels"))
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
    fm = DeviceFMIndex.from_planar(torch.zeros((2, 4), dtype=torch.int32),
                                   torch.zeros(8, dtype=torch.int32),
                                   torch.zeros(5, dtype=torch.int32), 1, 128, 64)
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


def test_sharded_launchers_refuse_cpu_tensors():
    """The sharded entry points of K5, S1 and S3 take CUDA tensors only;
    their wrappers give CPU tensors to the plain versions instead."""
    from arachne_tpu_torch.ops.cuda_rank import rank_sharded_cuda
    from arachne_tpu_torch.ops.cuda_seed import pass3_sharded_cuda, smem_pass_sharded_cuda
    from arachne_tpu_torch.ops.fm_rank import DeviceFMIndex, ShardedFMIndex, occ4_device

    fm = DeviceFMIndex.from_planar(torch.zeros((2, 4), dtype=torch.int32),
                                   torch.zeros(8, dtype=torch.int32),
                                   torch.tensor([0, 128, 128, 128, 128], dtype=torch.int32),
                                   64, 128, 64)
    sharded = ShardedFMIndex(fm, ["cpu", "cpu"])
    assert sharded.pointers is None and len(sharded.shards) == 2 and sharded.per == 1
    qs = torch.zeros((2, 32), dtype=torch.int8)
    v = torch.ones(2, dtype=torch.int32)
    launchers = (rank_sharded_cuda, smem_pass_sharded_cuda, pass3_sharded_cuda)
    before = [f.launches for f in launchers]
    with pytest.raises(ValueError, match="expected a CUDA device"):
        rank_sharded_cuda(sharded, v)
    with pytest.raises(ValueError, match="expected a CUDA device"):
        smem_pass_sharded_cuda(sharded, qs, v, v, v, False, 12, 48)
    with pytest.raises(ValueError, match="expected a CUDA device"):
        pass3_sharded_cuda(sharded, qs, v, 19, 20, 48)
    assert [f.launches for f in launchers] == before
    assert torch.equal(occ4_device(sharded, v), occ4_device(fm, v))


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
