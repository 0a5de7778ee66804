"""A tiny cell for the CPU tests: a checkout-like root under a temporary
directory whose BENCHMARK.json names one small configuration and mix,
run with the program's torch-cpu engine (the kernels' plain versions)."""

import json
import os
import shutil

HERE = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
REPO = os.path.dirname(HERE)


def small_genome(contigs: int, contig_len: int, seed: int) -> dict:
    """The benchmark's human256m genome entry, cut to ``contigs`` of
    ``contig_len`` and made from ``seed``."""
    with open(os.path.join(HERE, "configs", "human256m.json")) as fh:
        genome = json.load(fh)["genome"]
    return dict(genome, contigs=contigs, contig_len=contig_len, seed=seed)


TINY_CONFIG = {"genome": small_genome(2, 150000, 3), "threads": 2}
TINY_TRAFFIC = {"n_barcodes": 8, "molecules_per_barcode": 2, "pairs_per_molecule": 5,
                "molecule_len": 20000, "indel_rate": 0.1, "vary_quals": True,
                "pool_pairs_per_s": 150, "check_pairs": 10 ** 6}


def make_root(path, config=TINY_CONFIG, traffic=TINY_TRAFFIC):
    """A root at ``path`` holding a copy of the harness's metrics and a
    BENCHMARK.json with the cell ``tiny.mini``: returns (root, bench)."""
    bdir = os.path.join(path, "h100_bench")
    os.makedirs(os.path.join(bdir, "configs"), exist_ok=True)
    os.makedirs(os.path.join(bdir, "traffic"), exist_ok=True)
    shutil.copytree(os.path.join(HERE, "metrics"), os.path.join(bdir, "metrics"),
                    dirs_exist_ok=True)
    with open(os.path.join(bdir, "configs", "tiny.json"), "w") as fh:
        json.dump(config, fh)
    with open(os.path.join(bdir, "traffic", "mini.json"), "w") as fh:
        json.dump(traffic, fh)
    with open(os.path.join(REPO, "BENCHMARK.json")) as fh:
        bench = json.load(fh)
    bench["configs"] = [{"name": "tiny", "source": "test", "file": "h100_bench/configs/tiny.json",
                         "reduced": [], "why": "test"}]
    bench["workloads"] = [{"name": "tiny.mini", "config": "tiny", "traffic": "mini", "chips": 1,
                           "why": "test"}]
    with open(os.path.join(path, "BENCHMARK.json"), "w") as fh:
        json.dump(bench, fh)
    return path, bench
