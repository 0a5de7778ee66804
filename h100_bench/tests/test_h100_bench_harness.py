"""The harness's arithmetic and wiring, on the CPU."""

import json
import os
import shutil
import subprocess
import sys
import time

import numpy as np
import pytest

from h100_bench import bench as hb
from h100_bench import catalog, genomes, library, window, work
from h100_bench.probes import FedSet, Probes

from .tiny import REPO, small_genome


def test_every_part_of_the_benchmark_is_found_by_name():
    bench = catalog.load(REPO)
    for c in bench["workloads"]:
        cfg = catalog.config(bench, REPO, c["config"])
        assert cfg["name"] == c["config"] and int(cfg["threads"]) >= 1
        assert catalog.traffic(REPO, c["traffic"])["check_pairs"] > 0
    for m in bench["per_layer"]:
        assert callable(catalog.reader(REPO, m["name"]))


def test_a_config_mix_metric_and_cell_added_as_files_alone(tmp_path):
    root = str(tmp_path)
    shutil.copytree(os.path.join(REPO, "h100_bench"), os.path.join(root, "h100_bench"),
                    ignore=shutil.ignore_patterns("cache", "__pycache__"))
    bench = catalog.load(REPO)
    bdir = os.path.join(root, "h100_bench")
    with open(os.path.join(bdir, "configs", "added.json"), "w") as fh:
        json.dump({"genome": small_genome(1, 50000, 1), "threads": 3}, fh)
    with open(os.path.join(bdir, "traffic", "added.json"), "w") as fh:
        json.dump({"n_barcodes": 2, "pool_pairs_per_s": 1, "check_pairs": 5}, fh)
    with open(os.path.join(bdir, "metrics", "added_metric.py"), "w") as fh:
        fh.write("def read(run):\n    return run['pairs'] * 2\n")
    bench["configs"].append({"name": "added", "source": "s", "why": "w", "reduced": [],
                             "file": "h100_bench/configs/added.json"})
    bench["workloads"].append({"name": "added.added", "config": "added", "traffic": "added",
                               "chips": 1, "why": "w"})
    bench["per_layer"].append({"name": "added_metric", "unit": "x", "better": "higher",
                               "source": "program_counter", "layer": "l", "moves": "pairs_per_s",
                               "workloads": ["added.added"]})
    with open(os.path.join(root, "BENCHMARK.json"), "w") as fh:
        json.dump(bench, fh)
    loaded = catalog.load(root)
    cell = catalog.cell(loaded, "added.added")
    assert catalog.config(loaded, root, cell["config"])["threads"] == 3
    assert catalog.traffic(root, "added")["n_barcodes"] == 2
    per = catalog.metrics_of(loaded, "added.added", "per_layer")
    assert "added_metric" in [m["name"] for m in per]
    first = bench["workloads"][0]["name"]
    assert "added_metric" not in [m["name"] for m in catalog.metrics_of(loaded, first, "per_layer")]
    got = catalog.read_metrics(root, [m for m in per if m["name"] == "added_metric"],
                               {"pairs": 21})
    assert got == {"added_metric": {"value": 42.0, "unit": "x"}}
    # and the harness makes the added configuration's genome
    genomes.write_genome(os.path.join(root, "g.fa"),
                         catalog.config(loaded, root, "added")["genome"])
    assert genomes.read_contigs(os.path.join(root, "g.fa"))[0][0] == "chr1"


@pytest.mark.parametrize("genome", [
    {"generator": "scale", "contigs": 2, "contig_len": 30000, "seed": 7},
    small_genome(2, 30000, 7),
], ids=["scale", "composition"])
def test_genomes_are_fixed_by_their_own_seed(tmp_path, genome):
    a, b, c = (str(tmp_path / n) for n in ("a.fa", "b.fa", "c.fa"))
    genomes.write_genome(a, genome)
    genomes.write_genome(b, genome)
    genomes.write_genome(c, dict(genome, seed=genome["seed"] + 1))
    assert open(a, "rb").read() == open(b, "rb").read() != open(c, "rb").read()
    contigs = genomes.read_contigs(a)
    assert [len(s) for _, _, s in contigs] == [genome["contig_len"]] * genome["contigs"]


def test_the_genome_holds_the_stated_shares():
    """Each repeat class fills its stated share of a contig (to within
    one copy), copies lie end to end without overlap, and the unique rest
    is random sequence."""
    genome = small_genome(1, 2_000_000, 5)
    rng = np.random.default_rng(genome["seed"])
    fam = genomes.families(genome["classes"], rng)
    f, at, n, _ = genomes.copies(genome["classes"], fam, genome["contig_len"], rng)
    cls = fam[4][f]
    for ci, c in enumerate(genome["classes"]):
        want = c["share"] * genome["contig_len"]
        assert want <= n[cls == ci].sum() < want + fam[2][f][cls == ci].max()
        assert np.all(at[cls == ci] + n[cls == ci] <= fam[2][f][cls == ci])
    codes = genomes.make_genome(genome)[0][1]
    assert len(codes) == genome["contig_len"] and (codes == genomes.N_CODE).sum() <= 200


def test_libraries_are_fixed_by_the_seed(tmp_path):
    genomes.write_genome(str(tmp_path / "g.fa"), small_genome(1, 60000, 1))
    contigs = genomes.read_contigs(str(tmp_path / "g.fa"))
    traffic = {"n_barcodes": 5, "pairs_per_molecule": 4, "molecule_len": 20000,
               "pair_counts": {"rng": 11, "mean_pairs": 6, "sigma": 1.2, "big_barcode_pairs": 30},
               "invalid_every": 3, "vary_quals": True, "indel_rate": 0.5}
    big = 2 ** 31 + 12345
    runs = []
    for seed, d in ((big, "x"), (big, "y"), (big + 1, "z")):
        os.makedirs(tmp_path / d)
        libs = library.pool(contigs, traffic, seed, 2, str(tmp_path / d))
        runs.append([open(p).read() for r1, r2, _ in libs for p in (r1, r2)] +
                    [[n for _, _, n in libs]])
    assert runs[0] == runs[1]
    assert runs[0][:-1] != runs[2][:-1]
    # every seed: the same sizes, the giant barcode first
    assert runs[0][-1] == runs[2][-1]
    assert library.sim_config(traffic).pair_counts[0] == 30
    # the libraries of one run are different reads with different names
    assert runs[0][0] != runs[0][2] and "_10000000\t" not in runs[0][0]
    assert "_10000000" in runs[0][2]


def test_pool_holds_the_window_at_the_pool_rate():
    t = {"n_barcodes": 320, "molecules_per_barcode": 3, "pairs_per_molecule": 20,
         "pool_pairs_per_s": 2000}
    assert hb.pool_libraries(t, 30) == 2 + 4


def test_window_opens_and_closes_on_library_boundaries(monkeypatch):
    from h100_bench import probes as probes_mod

    clock = [0.0]
    monkeypatch.setattr(probes_mod.time, "perf_counter", lambda: clock[0])
    p = Probes([("r1", "r2", 6)] * 4, threads=2, seconds=5.0)
    # four libraries of three sets of 2 pairs; superbatches end at sets 1, 3, 5, ...
    for lib in range(4):
        for k in range(3):
            p.feed.append(FedSet(lib, k, 2, k == 2, [f"{lib}.{k}"]))
    p.batches = [(0.0, 1.0, 1), (0.0, 1.0, 3), (0.0, 1.0, 5), (0.0, 1.0, 7), (0.0, 1.0, 9),
                 (0.0, 1.0, 11)]

    class R:
        reads = [0, 0]

    note = p._note_barcode(lambda stats, res: None, dict)
    times = [1, 2, 3, 4, 5, 6, 7, 8, 9, 10, 12, 13]
    for t in times:
        clock[0] = float(t)
        note(None, R())
    # set 3 ends the second superbatch, set 5 the first library boundary after it
    assert (p.opened, p.t_open) == (5, 6.0)
    # 5 s later is 11: the first boundary at or after it is set 11 (at 13)
    assert (p.closed, p.t_close) == (11, 13.0) and p.stop
    pairs = window.window_pairs([fs.pairs for fs in p.feed], p.opened, p.closed)
    assert pairs == 12 and window.rate(pairs, p.t_open, p.t_close) == pytest.approx(12 / 7)


def test_window_opens_only_at_a_boundary():
    assert not window.opens_at(3, False, [1, 3], 2)
    assert not window.opens_at(2, True, [1, 3], 2)
    assert window.opens_at(3, True, [3, 1], 2)
    assert not window.closes_at(10.9, 6.0, 5.0, True)
    assert window.closes_at(11.0, 6.0, 5.0, True)
    assert not window.closes_at(12.0, 6.0, 5.0, False)


def test_busy_idle_and_gaps_on_made_up_timelines():
    spans = [(0.0, 4.0), (1.0, 2.0), (3.0, 9.0), (12.0, 20.0)]
    assert window.busy_share(spans, 2, 2.0, 12.0) == pytest.approx((2 + 0 + 6) / 20)
    dev = [(1.0, 3.0), (2.0, 4.0), (6.0, 7.0), (9.5, 11.0)]
    assert window.covered(dev, 0.0, 10.0) == pytest.approx(3.0 + 1.0 + 0.5)
    assert window.gaps(dev, 0.0, 10.0) == [(0.0, 1.0), (4.0, 6.0), (7.0, 9.5)]
    stages = [("io.write", 0.0, 0.8), ("rfa.host", 3.5, 8.0), ("cigar", 4.5, 5.5)]
    idle = window.idle_by_stage(dev, stages, 0.0, 10.0)
    assert idle == pytest.approx({"io.write": 1.0, "cigar+rfa.host": 2.0, "none": 2.5})
    # a union, not a sum: overlapping kernels count once
    assert window.covered([(0, 2), (1, 3), (1, 2)], 0, 10) == pytest.approx(3)


def test_band_cells_against_a_brute_force_count():
    rng = np.random.default_rng(5)
    probs = [(int(q), int(t), int(w)) for q, t, w in
             zip(rng.integers(1, 60, 40), rng.integers(1, 90, 40), rng.integers(0, 30, 40))]
    brute = sum(1 for q, t, w in probs for i in range(t) for j in range(q)
                if max(0, i - w) <= j < min(q, i + w + 1))
    assert work.band_cells(probs) == brute
    assert work.bound_s(132 * 64 * 1980e6, "NVIDIA H100 80GB HBM3", 1980.0) == pytest.approx(1.0)
    assert work.bound_s(1.0, "another card", 1980.0) is None


def test_forbidden_names_are_compared_whole(monkeypatch):
    monkeypatch.setitem(sys.modules, "arachne_tpu_torch_like", object())
    assert "arachne_tpu_torch_like" not in hb.forbidden_modules()
    monkeypatch.setitem(sys.modules, "arachne_tpu.sub", object())
    assert hb.forbidden_modules() == ["arachne_tpu.sub"]


def _loaded_top_names(code):
    out = subprocess.run([sys.executable, "-c", code + "\nimport sys, json\n"
                          "print(json.dumps(sorted({n.split('.')[0] for n in sys.modules})))"],
                         cwd=REPO, capture_output=True, text=True, check=True)
    return set(json.loads(out.stdout.strip().splitlines()[-1]))


def test_no_module_of_jax_or_the_jax_package_is_loaded():
    names = _loaded_top_names(
        "import h100_bench.bench, h100_bench.devtrace, h100_bench.control\n"
        "from h100_bench import catalog\n"
        "from arachne_tpu_torch import cli\n"
        "from arachne_tpu_torch.ops import engine, sw_global\n"
        "for m in catalog.load('.')['per_layer']: catalog.reader('.', m['name'])\n")
    assert "arachne_tpu_torch" in names
    assert not names & {"jax", "jaxlib", "flax", "arachne_tpu"}


def test_the_reference_loads_nothing_of_the_program():
    names = _loaded_top_names("import h100_bench.reference.oracle, h100_bench.check")
    assert not names & {"arachne_tpu_torch", "arachne_tpu", "jax", "jaxlib", "flax", "torch"}


@pytest.mark.cuda
def test_a_cell_runs_correct_on_the_card(tmp_path):
    import torch

    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    t0 = time.time()
    cell = catalog.load(REPO)["workloads"][0]["name"]
    out = subprocess.run([sys.executable, "h100_bench/run.py", "--workload", cell,
                          "--seed", "4000000007", "--seconds", "5", "--trace", "1"],
                         cwd=REPO, capture_output=True, text=True, timeout=1500)
    assert out.returncode == 0, out.stderr[-3000:]
    res = json.loads(out.stdout.strip().splitlines()[-1])
    assert res["correct"] and res["device"]["busy_s"] > 0, (res, time.time() - t0)
