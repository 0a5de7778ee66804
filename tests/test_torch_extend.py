"""The port's seed extension (arachne_tpu_torch/ops/sw_extend.py) against
the JAX package: the plain PyTorch version of kernel K1 must equal the XLA
extend_batch_kernel, the Pallas kernel (interpret mode) and the scalar
ksw.extend2 oracle exactly, on the same numpy inputs.  Integer outputs:
tolerance 0."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from arachne_tpu import config as ref_config
from arachne_tpu.align import ksw
from arachne_tpu.ops.pallas_extend import extend_batch_pallas
from arachne_tpu.ops.sw_extend import BatchExtender as JaxBatchExtender
from arachne_tpu.ops.sw_extend import extend_batch_kernel
from arachne_tpu_torch.config import MemOptions
from arachne_tpu_torch.ops.sw_extend import (
    BatchExtender,
    clamp_band,
    extend_batch,
    extend_batch_torch,
    int16_max_h0,
    int16_state_fits,
)

torch.set_num_threads(1)
OPT = MemOptions()
FIELDS = ("score", "qle", "tle", "gtle", "gscore", "max_off")


def problems(seed, B, qmax, tmax, opt=OPT, n_rate=0.0, w_range=(5, 120)):
    rng = np.random.default_rng(seed)
    ts = rng.integers(0, 5 if n_rate else 4, (B, tmax)).astype(np.int8)
    qs = np.full((B, qmax), 4, np.int8)
    qlens = np.zeros(B, np.int32)
    tlens = np.zeros(B, np.int32)
    ws = np.zeros(B, np.int32)
    h0s = np.zeros(B, np.int32)
    max_mat = int(opt.scoring_matrix().max())
    for i in range(B):
        ql = int(rng.integers(15, qmax + 1))
        tl = int(rng.integers(20, tmax + 1))
        q = ts[i, :ql].copy()
        nmut = int(rng.integers(0, 10))
        q[rng.integers(0, ql, nmut)] = rng.integers(0, 5, nmut)
        if n_rate:
            q[rng.random(ql) < n_rate] = 4
        qs[i, :ql] = q
        qlens[i] = ql
        tlens[i] = tl
        ws[i] = clamp_band(opt, ql, int(rng.integers(*w_range)), opt.pen_clip5, max_mat)
        h0s[i] = int(rng.integers(1, 50))
    return qs, ts, qlens, tlens, ws, h0s


def gaps(opt=OPT):
    return dict(o_del=opt.o_del, e_del=opt.e_del, o_ins=opt.o_ins, e_ins=opt.e_ins)


def run_jax(arrs, opt=OPT, zdrop=None):
    qs, ts = arrs[0], arrs[1]
    out = extend_batch_kernel(
        *[jnp.asarray(x) for x in arrs],
        jnp.asarray(opt.scoring_matrix(), jnp.int32),
        qmax=qs.shape[1], tmax=ts.shape[1],
        zdrop=opt.zdrop if zdrop is None else zdrop, **gaps(opt),
    )
    return np.stack([np.asarray(o) for o in out])


def run_torch(arrs, opt=OPT, zdrop=None, **kw):
    mat = torch.as_tensor(opt.scoring_matrix(), dtype=torch.int32)
    out = extend_batch_torch(
        *[torch.from_numpy(x) for x in arrs], mat,
        zdrop=opt.zdrop if zdrop is None else zdrop, **gaps(opt), **kw,
    )
    assert out.dtype == torch.int32 and out.shape == (6, arrs[0].shape[0])
    return out.numpy()


def assert_fields_equal(ref, got):
    for k, name in enumerate(FIELDS):
        np.testing.assert_array_equal(ref[k], got[k], err_msg=name)


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_plain_matches_jax_and_oracle(seed):
    arrs = problems(seed, 40, 128, 192)
    got = run_torch(arrs)
    assert_fields_equal(run_jax(arrs), got)
    qs, ts, qlens, tlens, ws, h0s = arrs
    mat = OPT.scoring_matrix()
    for b in range(len(qs)):
        ref = ksw.extend2(
            qs[b, : qlens[b]], ts[b, : tlens[b]], mat, OPT.o_del, OPT.e_del,
            OPT.o_ins, OPT.e_ins, int(ws[b]), OPT.pen_clip5, OPT.zdrop, int(h0s[b]),
        )
        assert tuple(got[:, b]) == tuple(ref), b


def test_plain_matches_pallas_interpret():
    arrs = problems(5, 16, 64, 96)
    qs, ts = arrs[0], arrs[1]
    out = extend_batch_pallas(
        *[jnp.asarray(x) for x in arrs], qmax=64, tmax=96, a=OPT.a, b=OPT.b,
        zdrop=OPT.zdrop, **gaps(), b_tile=16, interpret=True,
    )
    assert_fields_equal(np.stack([np.asarray(o) for o in out]), run_torch(arrs))


EDGE_CASES = ["zdrop_off", "narrow_band", "tlen_zero", "n_bases", "tiny_zdrop"]


def edge_case(case):
    """(problems, zdrop or None) of one of ``EDGE_CASES``."""
    kw = {}
    zdrop = None
    if case == "zdrop_off":
        zdrop = 0
    elif case == "narrow_band":
        kw["w_range"] = (1, 3)
    elif case == "n_bases":
        kw["n_rate"] = 0.15
    elif case == "tiny_zdrop":
        zdrop = 5
    arrs = problems(11, 24, 64, 128, **kw)
    if case == "tlen_zero":
        arrs[3][::3] = 0
    return arrs, zdrop


@pytest.mark.parametrize("case", EDGE_CASES)
def test_edge_cases_match_jax(case):
    arrs, zdrop = edge_case(case)
    assert_fields_equal(run_jax(arrs, zdrop=zdrop), run_torch(arrs, zdrop=zdrop))


def test_custom_scoring_matrix_matches_jax():
    """Any MemOptions matrix works: the kernel reads it from a table, so the
    port has no fallback for non-default scoring."""
    opt = MemOptions(a=2, b=3, o_del=5, e_del=2, o_ins=4, e_ins=1, zdrop=60)
    arrs = problems(3, 24, 64, 128, opt=opt)
    assert_fields_equal(run_jax(arrs, opt=opt), run_torch(arrs, opt=opt))


def test_batch_extender_matches_jax_batcher():
    rng = np.random.default_rng(9)
    ours = BatchExtender(OPT, torch.device("cpu"))
    ref = JaxBatchExtender(ref_config.MemOptions())
    for _ in range(30):
        t = rng.integers(0, 4, int(rng.integers(1, 300))).astype(np.uint8)
        q = t[: int(rng.integers(1, min(len(t), 150) + 1))].copy()
        q[rng.integers(0, len(q), 3)] = rng.integers(0, 4, 3)
        args = (q, t, int(rng.integers(1, 200)), OPT.pen_clip5, int(rng.integers(1, 60)))
        ours.submit(*args)
        ref.submit(*args)
    assert ours.run() == [tuple(int(x) for x in r) for r in ref.run()]
    assert ours.run() == []


def test_wrapper_uses_plain_version_for_cpu_tensors():
    arrs = problems(4, 8, 64, 96)
    mat = torch.as_tensor(OPT.scoring_matrix(), dtype=torch.int32)
    got = extend_batch(*[torch.from_numpy(x) for x in arrs], mat, zdrop=OPT.zdrop, **gaps())
    np.testing.assert_array_equal(got.numpy(), run_torch(arrs))



# ----------------------------------------------------------------------
# int16 DP state (wide_state=False): the reference's extend_batch_pallas
# with sdt=jnp.int16, interpret mode on the CPU
# ----------------------------------------------------------------------


def pallas_problems(seed, B, qmax, tmax, opt=OPT):
    """The inputs of the reference's int16 test (tests/test_pallas.py
    ``_random_problems``): targets with N, bands clamped at max_mat 1."""
    rng = np.random.default_rng(seed)
    ts = rng.integers(0, 5, (B, tmax)).astype(np.int8)
    qs = np.full((B, qmax), 4, np.int8)
    qlens, tlens, ws, h0s = (np.zeros(B, np.int32) for _ in range(4))
    for i in range(B):
        ql = int(rng.integers(15, qmax + 1))
        tl = int(rng.integers(20, tmax + 1))
        q = ts[i, :ql].copy()
        nmut = int(rng.integers(0, 10))
        q[rng.integers(0, ql, nmut)] = rng.integers(0, 5, nmut)
        qs[i, :ql] = q
        qlens[i], tlens[i] = ql, tl
        ws[i] = clamp_band(opt, ql, int(rng.integers(5, 120)), opt.pen_clip5, 1)
        h0s[i] = int(rng.integers(1, 50))
    return qs, ts, qlens, tlens, ws, h0s


def run_pallas16(arrs, opt=OPT, zdrop=None):
    qs, ts = arrs[0], arrs[1]
    out = extend_batch_pallas(
        *[jnp.asarray(x) for x in arrs], qmax=qs.shape[1], tmax=ts.shape[1], a=opt.a, b=opt.b,
        zdrop=opt.zdrop if zdrop is None else zdrop, **gaps(opt), b_tile=qs.shape[0],
        interpret=True, wide_state=False,
    )
    return np.stack([np.asarray(o) for o in out])


def oracle(arrs, opt=OPT, zdrop=None):
    qs, ts, qlens, tlens, ws, h0s = arrs
    mat = opt.scoring_matrix()
    return np.array([ksw.extend2(
        qs[b, : qlens[b]], ts[b, : tlens[b]], mat, opt.o_del, opt.e_del, opt.o_ins, opt.e_ins,
        int(ws[b]), opt.pen_clip5, opt.zdrop if zdrop is None else zdrop, int(h0s[b]),
    ) for b in range(len(qs))]).T


@pytest.mark.parametrize("seed", [3, 4])
def test_int16_plain_matches_pallas_int16_int32_and_oracle(seed):
    """The reference's own int16 parity inputs (B 64, 128 x 192): the port's
    int16 plain version equals extend_batch_pallas(wide_state=False), the
    port's int32 plain version and ksw.extend2 on every field."""
    arrs = pallas_problems(seed, 64, 128, 192)
    got = run_torch(arrs, wide_state=False)
    assert_fields_equal(run_pallas16(arrs), got)
    assert_fields_equal(run_torch(arrs), got)
    assert_fields_equal(oracle(arrs), got)


@pytest.mark.parametrize("case", EDGE_CASES)
def test_int16_edge_cases_match_jax(case):
    arrs, zdrop = edge_case(case)
    got = run_torch(arrs, zdrop=zdrop, wide_state=False)
    assert_fields_equal(run_pallas16(arrs, zdrop=zdrop), got)
    assert_fields_equal(run_jax(arrs, zdrop=zdrop), got)
    assert_fields_equal(run_torch(arrs, zdrop=zdrop), got)


def test_int16_custom_scoring_matrix_matches_jax():
    """The custom matrix of ``test_custom_scoring_matrix_matches_jax``: the
    reference's int16 kernel scores by a and b, which make this matrix."""
    opt = MemOptions(a=2, b=3, o_del=5, e_del=2, o_ins=4, e_ins=1, zdrop=60)
    arrs = problems(3, 24, 64, 128, opt=opt)
    got = run_torch(arrs, opt=opt, wide_state=False)
    assert_fields_equal(run_pallas16(arrs, opt=opt), got)
    assert_fields_equal(run_jax(arrs, opt=opt), got)
    assert_fields_equal(oracle(arrs, opt=opt), got)


def top_h0(qmax, opt=OPT):
    return int16_max_h0(qmax, opt.scoring_matrix(), opt.e_ins, o_del=opt.o_del, e_del=opt.e_del,
                        o_ins=opt.o_ins)


def test_int16_range_proof_is_exact_at_its_boundary():
    """int16_state_fits accepts the largest max(h0) that fits and refuses the
    next; at the last accepted value every h0 of the batch sits there and
    the int16 plain version (and the reference's int16 kernel) still equal
    int32; one past it, both wrappers refuse, with or without max_h0."""
    qmax, tmax = 64, 128
    top = top_h0(qmax)
    assert top == (1 << 15) - 1 - 1 * qmax - qmax * OPT.e_ins
    mat = OPT.scoring_matrix()
    fits = lambda h0: int16_state_fits(h0, qmax, mat, OPT.e_ins, o_del=OPT.o_del,
                                       e_del=OPT.e_del, o_ins=OPT.o_ins)
    assert fits(top) and not fits(top + 1) and fits(0) and not fits(-1)
    arrs = list(problems(21, 24, qmax, tmax))
    arrs[5] = np.full(24, top, np.int32)
    got = run_torch(arrs, wide_state=False)
    assert_fields_equal(run_torch(arrs), got)
    assert_fields_equal(run_pallas16(arrs), got)
    assert got[0].max() > top
    arrs[5] = arrs[5] + 1
    t = [torch.from_numpy(x) for x in arrs]
    mat_t = torch.as_tensor(mat, dtype=torch.int32)
    for max_h0 in (None, top + 1):
        with pytest.raises(ValueError, match="int16"):
            extend_batch(*t, mat_t, zdrop=OPT.zdrop, **gaps(), wide_state=False, max_h0=max_h0)
    with pytest.raises(ValueError, match="int16"):
        extend_batch_torch(*t, mat_t, zdrop=OPT.zdrop, **gaps(), wide_state=False)


def test_int16_range_proof_at_the_main_shapes_and_its_other_limits():
    """The main path's widths hold with a wide margin (h0 <= 150 for 150 bp
    reads); gap extensions as large as the scan's identity allows, and a
    matrix whose lowest score less a gap leaves int16, are refused at any
    h0; a negative h0 is refused."""
    assert top_h0(192) == 32_383 and top_h0(1024) == 30_719
    mat = OPT.scoring_matrix()
    assert int16_max_h0(1024, mat, 24, o_del=6, e_del=1, o_ins=6) == 32_767 - 1024 - 1024 * 24
    assert int16_max_h0(1024, mat, 25, o_del=6, e_del=1, o_ins=6) == -1
    low = mat.astype(np.int32)
    low[0, 1] = -(1 << 15) + 7
    assert int16_max_h0(192, low, 1, o_del=6, e_del=1, o_ins=6) == 32_383
    low[0, 1] -= 1
    assert int16_max_h0(192, low, 1, o_del=6, e_del=1, o_ins=6) == -1
    arrs = [torch.from_numpy(x) for x in problems(5, 8, 64, 96)]
    arrs[5][0] = -1
    with pytest.raises(ValueError, match="h0 >= 0"):
        extend_batch(*arrs, torch.as_tensor(mat, dtype=torch.int32), zdrop=OPT.zdrop, **gaps(),
                     wide_state=False)


def test_batch_extender_keeps_int32_state(monkeypatch):
    """The batcher's launches keep the int32 state, as the reference's
    dispatcher does: choosing int16 there waits for a benchmark."""
    from arachne_tpu_torch.ops import sw_extend

    seen = []
    real = sw_extend.extend_batch
    monkeypatch.setattr(sw_extend, "extend_batch",
                        lambda *a, **kw: seen.append(kw.get("wide_state", True)) or real(*a, **kw))
    ours = BatchExtender(OPT, torch.device("cpu"))
    rng = np.random.default_rng(4)
    for _ in range(5):
        t = rng.integers(0, 4, 120).astype(np.uint8)
        ours.submit(t[:90].copy(), t, 50, OPT.pen_clip5, 30)
    assert len(ours.run()) == 5 and seen == [True]
