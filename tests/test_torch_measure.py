"""The main-path measurement driver (arachne_tpu_torch.measure) on the CPU,
at a tiny library: a timed trial through the kernels' plain versions, the
same library through the oracle engine with byte-identical shards, and the
JSON result it writes."""

import json

import pytest
import torch

from arachne_tpu_torch import measure

torch.set_num_threads(1)

TINY = ["--genome-bp", "60000", "--barcodes", "2", "--molecules", "1", "--pairs", "6",
        "--molecule-len", "8000", "-t", "1"]


def test_trial_and_compare_on_cpu(tmp_path):
    out = tmp_path / "measure.json"
    res = measure.main(["--engine", "torch-cpu", "--trials", "1", "--compare", "oracle",
                        "--bands", "--out", str(out)] + TINY)
    n = res["library"]["pairs"]
    assert n == 12
    (trial,) = res["trials"]
    assert trial["pairs"] == n and trial["pairs_per_s"] > 0
    assert "extend.device" in trial["stages_s"]
    (cmp,) = res["compare"]
    assert cmp["engine"] == "oracle" and cmp["pairs"] == n
    assert cmp["identical"] and all(cmp["identical"].values())
    assert json.loads(out.read_text())["library"]["pairs"] == n
    # only reads whose extension left a gap reach BatchGlobal
    assert 1 <= sum(res["bands"].values()) <= 2 * n and all(int(w) >= 0 for w in res["bands"])
    from arachne_tpu_torch.ops.sw_global import BatchGlobal
    assert BatchGlobal.submit.__name__ == "submit"          # the recorder is gone


def test_profile_needs_the_card():
    with pytest.raises(SystemExit):
        measure.main(["--engine", "torch-cpu", "--profile"] + TINY)
