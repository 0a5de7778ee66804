"""The kernel library's routing and alignment checks, the A/B tool's
refusals and seeding cases, and chip_smoke's bound, on the CPU (nothing
here builds or launches a kernel)."""

import os

import pytest
import torch

import chip_smoke
from arachne_tpu_torch import ab
from arachne_tpu_torch.ops import build
from arachne_tpu_torch.ab import SEEDING, seeding_problems
from arachne_tpu_torch.ops.problems import MAIN

torch.set_num_threads(1)


def test_routed_to_swaps_the_library_and_restores_it(monkeypatch):
    mine, other = object(), object()
    monkeypatch.setattr(build, "_lib", mine)
    with build.routed_to(other):
        assert build.get_lib() is other
    assert build.get_lib() is mine
    with pytest.raises(KeyError):
        with build.routed_to(other):
            raise KeyError("a failed launch")
    assert build.get_lib() is mine


def test_build_dir_follows_the_sources(tmp_path):
    """Another checkout's sources build into their own directory, never
    over this checkout's library."""
    for name in ("a.cu", "common.cuh"):
        (tmp_path / name).write_text("// " + name)
    other = build.build_dir(str(tmp_path))
    assert other != build.build_dir()
    assert os.path.dirname(other) == os.path.dirname(build.build_dir())
    assert build.sources(str(tmp_path)) == [str(tmp_path / "a.cu"), str(tmp_path / "common.cuh")]
    (tmp_path / "a.cu").write_text("// changed")
    assert build.build_dir(str(tmp_path)) != other


@pytest.mark.parametrize("argv", [["no/such/checkout"], [".", "--kernels", "K9"]])
def test_ab_refuses_before_touching_a_card(argv, capsys):
    with pytest.raises(SystemExit) as e:
        ab.main(argv)
    assert e.value.code != 0


def test_ab_covers_the_main_path_dp_kernels():
    assert set(MAIN) == {"K1", "K2", "K3 score", "K3 z", "K4"}
    assert MAIN["K3 z"] == MAIN["K4"]


@pytest.mark.parametrize("kw,ms,by", [
    # 45.6 M cells x 5 instructions over 132 x 64 lanes at 1980 MHz
    (dict(ops=45_600_000 * chip_smoke.DP_INSTR_PER_CELL), 0.013630, "operations"),
    # 64 MB at the data sheet's HBM rate
    (dict(nbytes=64e6), 0.019104, "bytes"),
    # the same bytes at an L2 rate of 8 TB/s
    (dict(nbytes=64e6, bytes_per_s=8e12), 0.008, "bytes"),
])
def test_bound_takes_the_slower_of_operations_and_bytes(monkeypatch, kw, ms, by):
    monkeypatch.setitem(chip_smoke.CLOCKS, "max_sm", 1980.0)
    got = chip_smoke.bound(**kw)
    assert got["bound_by"] == by
    assert got["bound_ms"] == pytest.approx(ms, rel=1e-4)


def test_ab_takes_the_seeding_kernels():
    a = ab.parser().parse_args([".", "--kernels", *SEEDING])
    assert a.kernels == ["S1 pass 1", "S1 pass 2", "S3", "K5", "K5 index"]
    with pytest.raises(SystemExit):
        ab.parser().parse_args([".", "--kernels", "S2"])


def test_seeding_problems_build_their_inputs():
    """The seeding cases at a tiny size on the CPU, through the wrappers'
    plain versions: each case's arguments fit its wrapper, and ab routes
    them to the CUDA launchers as they are."""
    from arachne_tpu_torch.ops import fm_rank, fm_seed
    from arachne_tpu_torch.ops.cuda_rank import rank_cuda
    from arachne_tpu_torch.ops.cuda_seed import pass3_cuda, smem_pass_cuda

    cases = seeding_problems("cpu", genome_bp=60_000, n_pairs=24, wide_blocks=16, rank_rows=999,
                             barcodes=2, molecules=1, pairs=20, molecule_len=8000)
    assert list(cases) == list(SEEDING)
    fm, qs, qlens = cases["S1 pass 1"][:3]
    assert qs.shape == (64, 192) and int((qlens > 0).sum()) == 48
    B = fm_seed.seed_buffers(192)
    out, n, ovf = fm_seed.smem_pass(*cases["S1 pass 1"])
    assert out.shape == (64, B, 5) and int(n.sum()) > 0 and not bool(ovf.any())
    J = cases["S1 pass 2"][1].shape[0]
    assert 24 <= J and cases["S1 pass 2"][5] is True
    out2, n2, _ = fm_seed.smem_pass(*cases["S1 pass 2"])
    assert out2.shape == (J, B, 5) and int(n2.min()) >= 1
    assert fm_seed.pass3(*cases["S3"])[0].shape == (64, B, 5)
    wide, ks = cases["K5"]
    assert wide.idt == torch.int64 and fm_rank.occ4_device(wide, ks).shape == (999, 4)
    narrow, ks = cases["K5 index"]
    assert narrow is fm and fm_rank.occ4_device(narrow, ks).shape == (999, 4)
    launchers = (smem_pass_cuda, smem_pass_cuda, pass3_cuda, rank_cuda, rank_cuda)
    for name, launcher in zip(SEEDING, launchers, strict=True):
        fn, args, kw = ab.case(name, torch.device("cpu"), None, cases)
        assert fn is launcher and args == list(cases[name]) and kw == {}


def test_tables_off_16_bytes_are_refused():
    """rank.cuh reads a record of the table as one aligned 64-byte line: a
    view that starts inside an allocation, off 64 bytes, is refused before
    any launch (and the helper refuses any other size it is given)."""
    import torch

    t = torch.zeros(64, dtype=torch.int32)
    build.require_aligned(t, "table", 64)
    build.require_aligned(t[16:], "table", 64)
    build.require_aligned(t[4:], "words", 16)
    with pytest.raises(ValueError, match="not on 64 bytes"):
        build.require_aligned(t[4:], "table", 64)
    with pytest.raises(ValueError, match="not on 16 bytes"):
        build.require_aligned(t[1:], "words", 16)


def test_ab_knows_a_parent_with_planar_tables(tmp_path):
    """ab hands a parent whose seeding entry points take occ and words
    apart (before the record table) planar copies; this checkout's own
    sources take the record table."""
    assert not ab.takes_planar_tables(build.CSRC)
    (tmp_path / "rank.cu").write_text(
        'extern "C" int arachne_rank(\n    const void* occ, const void* words, const void* L2,')
    assert ab.takes_planar_tables(str(tmp_path))
    assert len(ab.PLANAR_SIGNATURES["arachne_rank"]) == len(build._SIGNATURES["arachne_rank"]) + 1


class _Span:
    def __init__(self, us):
        self.us = us

    def elapsed_us(self):
        return self.us


class _Record:
    def __init__(self, us, cuda=True):
        self.time_range = _Span(us)
        self.device_type = torch.autograd.DeviceType.CUDA if cuda else torch.autograd.DeviceType.CPU


def test_device_ms_throws_away_a_profile_that_lost_records(monkeypatch):
    """A profiler run whose device records are not the same for every call
    would read low: device_ms runs it again, and gives up with None."""
    from arachne_tpu_torch import device

    runs = [[_Record(100.0)] * 7 + [_Record(5.0, cuda=False)],   # 7 of 10 kernels recorded
            [_Record(100.0)] * 10 + [_Record(5.0, cuda=False)]]

    class FakeProfile:
        def __init__(self, activities, schedule):
            self.records = runs.pop(0) if runs else []
            self.steps = 0

        def __enter__(self):
            return self

        def __exit__(self, *exc):
            return False

        def step(self):
            self.steps += 1

        def events(self):
            assert self.steps == 2   # the warm-up step, then the recorded one
            return self.records

    monkeypatch.setattr(torch.profiler, "profile", FakeProfile)
    monkeypatch.setattr(torch.cuda, "synchronize", lambda: None)
    monkeypatch.setattr(device, "lost_profiles", 0)
    calls = []
    assert device.device_ms(lambda: calls.append(1), 10) == pytest.approx(0.1)
    assert device.lost_profiles == 1 and len(calls) == 22   # a warm call a run
    assert device.device_ms(lambda: None, 10) is None
    assert device.lost_profiles == 1 + device.PROFILE_TRIES


def test_ab_times_k1_int16_on_k1s_problems():
    """The "K1 int16" case: K1's MAIN problems through the int16 launcher,
    with the batch's max h0 as its host bound (no read of the card's h0s
    at each launch)."""
    from arachne_tpu_torch.config import MemOptions
    from arachne_tpu_torch.ops.cuda_extend import extend16_cuda, extend_cuda

    assert ab.parser().parse_args([".", "--kernels", "K1 int16"]).kernels == ["K1 int16"]
    fn32, args32, kw32 = ab.case("K1", torch.device("cpu"), MemOptions())
    fn, args, kw = ab.case("K1 int16", torch.device("cpu"), MemOptions())
    assert fn32 is extend_cuda and fn is extend16_cuda
    assert all(torch.equal(a, b) for a, b in zip(args, args32, strict=True))
    assert kw == dict(kw32, max_h0=int(args32[5].max()))


def test_chip_smoke_names_the_int16_form_of_k1():
    """The kernel table's K1 int16 row names its own launcher and the line
    of the reference that picks the int16 state; its bound counts two
    cells an instruction."""
    rows = {key: (fn, src, rep) for key, fn, src, rep in chip_smoke.KERNELS}
    fn, src, rep = rows["K1 int16"]
    assert fn == "extend16_cuda" and src == rows["K1"][1]
    path, line = rep.split(":")
    root = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    with open(os.path.join(root, path)) as fh:
        assert "jnp.int16" in fh.read().splitlines()[int(line) - 1]
    assert "K1 int16" in chip_smoke.launchers()
