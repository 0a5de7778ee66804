"""The port's graft entry points and study scripts on the CPU:

  * ``arachne_tpu_torch.graft_entry.entry()`` gives the inputs of the
    reference's ``__graft_entry__.entry()`` and, through the K1 path's
    plain version, its outputs (JAX on the CPU runs the reference's XLA
    extend_batch_kernel);
  * ``dryrun_multichip`` passes with the pool over two CPU entries;
  * ``scripts/scaling_study`` and ``scripts/rfa_study`` run at a tiny size
    with ``--engine torch-cpu``; the decisive RFA fixture gives the
    reference's recorded result (BASELINE.md, round 4).

Integers: tolerance 0."""

import jax
import numpy as np
import pytest
import torch

import __graft_entry__ as reference_entry
from arachne_tpu_torch import graft_entry

torch.set_num_threads(1)


def test_entry_equals_the_references():
    ref_fn, ref_args = reference_entry.entry()
    want = np.stack([np.asarray(o) for o in jax.jit(ref_fn)(*ref_args)])
    fn, args = graft_entry.entry("cpu")
    assert len(args) == len(ref_args)
    for a, r in zip(args, ref_args):
        assert a.device.type == "cpu" and np.array_equal(a.numpy(), np.asarray(r))
    got = fn(*args)
    assert got.dtype == torch.int32 and np.array_equal(got.numpy(), want)


def test_entry_raises_without_a_card(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="cuda"):
        graft_entry.entry()


@pytest.mark.parametrize("n_devices", [1, 2])
def test_dryrun_multichip_on_the_cpu(n_devices, capsys):
    graft_entry.dryrun_multichip(n_devices, "cpu")
    out = capsys.readouterr().out
    assert f"OK on {n_devices} x cpu" in out and f"spread {n_devices} chunks" in out


def test_scaling_study_at_a_tiny_size(monkeypatch, tmp_path):
    from arachne_tpu_torch.scripts import scaling_study

    monkeypatch.setenv("OMP_NUM_THREADS", "1")
    res = scaling_study.main(["--engine", "torch-cpu", "--pairs", "60", "--threads", "1",
                              "--devices", "1,2", "--out", str(tmp_path / "study.json")])
    assert set(res) == {"pool 1", "pool 2", "2 processes"}
    assert all(r["identical_to_first"] for r in res.values())
    assert res["pool 2"]["pairs"] == res["pool 1"]["pairs"] == 60
    assert sum(p["pairs"] for p in res["2 processes"]["processes"]) == 60
    assert "extend.device" in res["pool 1"]["stage_times"]


def test_rfa_study_at_a_tiny_size(tmp_path):
    from arachne_tpu_torch.scripts import rfa_study

    res = rfa_study.main([str(tmp_path), "--engine", "torch-cpu", "--barcodes", "4"])
    spaced = res["spaced-repeats"]
    assert spaced["reads"] > 0 and 0 < spaced["accuracy_off"] <= spaced["accuracy_on"] <= 1
    d = res["decisive"]
    # the reference's record: RFA-on 1.0000 against 0.9318 off, 6 records
    # moved, 24 interior reads at mapq 60 on and 3 off
    assert (d["reads"], d["accuracy_on"], d["accuracy_off"], d["moved"]) == (88, 1.0, 82 / 88, 6)
    assert d["interior_reads"] == 24
    assert set(d["interior_mapq_on"]) == {60} and set(d["interior_mapq_off"]) == {3}
