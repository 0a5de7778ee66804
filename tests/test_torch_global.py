"""The port's CIGAR-stage global alignment (arachne_tpu_torch/ops/
sw_global.py) against the JAX package: the plain PyTorch versions of
kernels K3 (score and direction bytes) and K4 (the backtrack walk) must
equal the XLA global_batch_kernel / traceback_device, the Pallas kernel
(interpret mode) and the scalar ksw.global2 oracle exactly.  Integer
outputs: tolerance 0.  The port keeps z as (B, tmax, qmax); the JAX
package's is (tmax, qmax, B).

The walk is the scalar oracle's: ksw.global2 keeps the F-continuation at
bit 4 of a direction byte (ksw.py:211) where K3 and the XLA kernel keep it
at bit 5, as ksw.c does, so the oracle's walk turns out of an insertion
into a deletion where traceback_device stays in it.  traceback_device run
over bytes with that bit moved to bit 4 (``scalar_bits``) takes the
oracle's turns, and the port's walk must equal it step for step."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from arachne_tpu import config as ref_config
from arachne_tpu.align import ksw
from arachne_tpu.ops.pallas_global import global_batch_pallas
from arachne_tpu.ops.sw_global import BatchGlobal as JaxBatchGlobal
from arachne_tpu.ops.sw_global import global_batch_kernel, traceback_device
from arachne_tpu_torch.config import MemOptions
from arachne_tpu_torch.ops import sw_global
from arachne_tpu_torch.ops.problems import edge_global_problems, repeat_insertion_problem
from arachne_tpu_torch.ops.sw_extend import lengths, padded_codes
from arachne_tpu_torch.ops.sw_global import (
    BatchGlobal,
    decode_traceback_ops,
    global_batch_torch,
    global_score,
    global_z,
    traceback,
    traceback_torch,
)

torch.set_num_threads(1)
OPT = MemOptions()
GAPS = dict(o_del=OPT.o_del, e_del=OPT.e_del, o_ins=OPT.o_ins, e_ins=OPT.e_ins)
MAT = OPT.scoring_matrix()
MAT_T = torch.as_tensor(MAT, dtype=torch.int32)


def problems(seed, B, qmax, tmax, max_indel=1, w_range=(3, 100)):
    rng = np.random.default_rng(seed)
    qs = np.full((B, qmax), 4, np.int8)
    ts = np.full((B, tmax), 4, np.int8)
    qlens = np.zeros(B, np.int32)
    tlens = np.zeros(B, np.int32)
    ws = np.zeros(B, np.int32)
    for i in range(B):
        t = rng.integers(0, 4, int(rng.integers(20, min(qmax, tmax) - 16))).astype(np.int8)
        q = list(t)
        for _ in range(int(rng.integers(0, 3))):
            j = int(rng.integers(1, len(q) - 1))
            n = int(rng.integers(1, max_indel + 1))
            if rng.random() < 0.5:
                del q[j : j + n]
            else:
                q[j:j] = list(rng.integers(0, 4, n))
        q = np.array(q, np.int8)
        q[rng.integers(0, len(q), 3)] = rng.integers(0, 5, 3)
        qs[i, : len(q)] = q
        ts[i, : len(t)] = t
        qlens[i] = len(q)
        tlens[i] = len(t)
        ws[i] = int(rng.integers(*w_range))
    return qs, ts, qlens, tlens, ws


def scalar_bits(z):
    """Direction bytes with the F-continuation at ksw.global2's bit 4."""
    z = np.asarray(z)
    return (z & ~np.uint8(32)) | ((z & np.uint8(32)) >> 1)


def jax_global(arrs, want_z):
    qs, ts = arrs[0], arrs[1]
    s, z = global_batch_kernel(
        *[jnp.asarray(x) for x in arrs], jnp.asarray(MAT, jnp.int32),
        qs.shape[1], ts.shape[1], OPT.o_del, OPT.e_del, OPT.o_ins, OPT.e_ins,
        want_z=want_z,
    )
    return np.asarray(s), (np.asarray(z).transpose(2, 0, 1) if want_z else None)


def torch_global(arrs, want_z):
    s, z = global_batch_torch(*[torch.from_numpy(x) for x in arrs], MAT_T, **GAPS, want_z=want_z)
    return s.numpy(), (z.numpy() if want_z else None)


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_global_matches_jax(seed):
    arrs = problems(seed, 32, 96, 160, max_indel=6)
    ref_s, ref_z = jax_global(arrs, True)
    got_s, got_z = torch_global(arrs, True)
    np.testing.assert_array_equal(ref_s, got_s)
    np.testing.assert_array_equal(ref_z, got_z)
    np.testing.assert_array_equal(torch_global(arrs, False)[0], got_s)


@pytest.mark.parametrize("seed", [3, 4])
def test_traceback_matches_jax_device_walk(seed):
    qs, ts, qlens, tlens, ws = arrs = problems(seed, 32, 96, 160, max_indel=6)
    _, ref_z = global_batch_kernel(
        *[jnp.asarray(x) for x in arrs], jnp.asarray(MAT, jnp.int32), 96, 160,
        OPT.o_del, OPT.e_del, OPT.o_ins, OPT.e_ins, want_z=True,
    )
    ref = traceback_device(
        jnp.asarray(scalar_bits(ref_z)), jnp.asarray(qlens), jnp.asarray(tlens), jnp.asarray(ws),
        qmax=96, tmax=160, max_steps=256,
    )
    z = torch.from_numpy(np.asarray(ref_z).transpose(2, 0, 1).copy())
    got = traceback_torch(
        z, *[torch.from_numpy(x) for x in (qlens, tlens, ws)], max_steps=256
    )
    for name, r, g in zip(("ops", "fi", "fk"), ref, got):
        np.testing.assert_array_equal(np.asarray(r), g.numpy(), err_msg=name)


def assert_plain_matches_scalar_oracle(arrs, max_steps):
    qs, ts, qlens, tlens, ws = arrs
    score, z = torch_global(arrs, True)
    ops, fi, fk = traceback_torch(
        torch.from_numpy(z), *[torch.from_numpy(x) for x in (qlens, tlens, ws)],
        max_steps=max_steps,
    )
    turned = 0
    for b in range(len(qs)):
        e_score, e_cig = ksw.global2(qs[b, : qlens[b]], ts[b, : tlens[b]], MAT, OPT.o_del,
                                     OPT.e_del, OPT.o_ins, OPT.e_ins, int(ws[b]))
        cig = decode_traceback_ops(ops[:, b].numpy(), int(fi[b]), int(fk[b]))
        assert (int(score[b]), cig) == (e_score, e_cig), b
        turned += any(a[0] == 2 and b_[0] == 1 for a, b_ in zip(cig, cig[1:]))
    return turned


def test_plain_score_and_cigar_match_scalar_oracle():
    """Indels of 1-6 bases: the CIGARs are the scalar oracle's, turns out
    of insertions into deletions (a D right before an I) included."""
    arrs = problems(5, 32, 96, 160, max_indel=6)
    assert assert_plain_matches_scalar_oracle(arrs, 256) > 0


@pytest.mark.parametrize("qmax,tmax", [(192, 320), (256, 400)])
def test_plain_walk_matches_scalar_oracle_on_edge_problems(qmax, tmax):
    """The edge set (runs of 36-40 inserted bases among them) and the
    repeat read whose insertion moved a second-best placement on the
    human-composition genome (``REPEAT_INSERTION``): CIGARs and scores
    equal the JAX package's scalar ksw.global2."""
    qs_l, ts_l, ws = edge_global_problems(90 + qmax, 27, qmax, tmax)
    rq, rt, rw = repeat_insertion_problem()
    qs_l, ts_l, ws = qs_l + rq, ts_l + rt, np.concatenate([ws, rw])
    arrs = (padded_codes(qs_l, qmax), padded_codes(ts_l, tmax), lengths(qs_l), lengths(ts_l), ws)
    assert assert_plain_matches_scalar_oracle(arrs, qmax + tmax) > 0
    _, cig = ksw.global2(rq[0], rt[0], MAT, OPT.o_del, OPT.e_del, OPT.o_ins, OPT.e_ins, int(rw[0]))
    assert cig == [(1, 6), (0, 47), (2, 1), (1, 1), (0, 15), (2, 2), (1, 1), (0, 80)]


@pytest.mark.parametrize("want_z", [False, True])
def test_global_matches_pallas_interpret(want_z):
    arrs = problems(6, 16, 64, 96)
    s, z = global_batch_pallas(
        *[jnp.asarray(x) for x in arrs], qmax=64, tmax=96, a=OPT.a, b=OPT.b, **GAPS,
        want_z=want_z, b_tile=16, interpret=True,
    )
    got_s, got_z = torch_global(arrs, want_z)
    np.testing.assert_array_equal(np.asarray(s), got_s)
    if want_z:
        np.testing.assert_array_equal(np.asarray(z).transpose(2, 0, 1), got_z)


@pytest.mark.parametrize("case", ["length_mismatch", "tlen_zero", "narrow_band"])
def test_edge_cases_match_jax(case):
    kw = dict(max_indel=15) if case == "length_mismatch" else {}
    if case == "narrow_band":
        kw["w_range"] = (1, 3)
    arrs = problems(7, 24, 96, 160, **kw)
    if case == "tlen_zero":
        arrs[3][::4] = 0
    ref_s, ref_z = jax_global(arrs, True)
    got_s, got_z = torch_global(arrs, True)
    np.testing.assert_array_equal(ref_s, got_s)
    np.testing.assert_array_equal(ref_z, got_z)


@pytest.mark.parametrize("qmax,tmax", [(64, 96), (192, 320)])
def test_edge_problem_set_matches_jax(qmax, tmax):
    """The edge problems the card holds K3 and K4 to (w = 0, 1 and wider
    than the query, tlen = 0, one-base queries, full-size problems, the
    corner cell on the band's edge, runs of 36-40 indels): the plain
    versions equal the JAX package's kernel and device walk on them."""
    qs_l, ts_l, ws = edge_global_problems(70 + qmax, 27, qmax, tmax)
    qlens, tlens = lengths(qs_l), lengths(ts_l)
    arrs = (padded_codes(qs_l, qmax), padded_codes(ts_l, tmax), qlens, tlens, ws)
    ref_s, jz = global_batch_kernel(
        *[jnp.asarray(x) for x in arrs], jnp.asarray(MAT, jnp.int32), qmax, tmax,
        OPT.o_del, OPT.e_del, OPT.o_ins, OPT.e_ins, want_z=True,
    )
    got_s, got_z = torch_global(arrs, True)
    np.testing.assert_array_equal(np.asarray(ref_s), got_s)
    np.testing.assert_array_equal(np.asarray(jz).transpose(2, 0, 1), got_z)
    steps = qmax + tmax - 13
    ref = traceback_device(jnp.asarray(scalar_bits(jz)), jnp.asarray(qlens),
                           jnp.asarray(tlens), jnp.asarray(ws),
                           qmax=qmax, tmax=tmax, max_steps=steps)
    got = traceback_torch(torch.from_numpy(got_z),
                          *[torch.from_numpy(x) for x in (qlens, tlens, ws)], max_steps=steps)
    for name, r, g in zip(("ops", "fi", "fk"), ref, got):
        np.testing.assert_array_equal(np.asarray(r), g.numpy(), err_msg=name)


def test_batch_global_matches_jax_batcher_and_counts_fetches():
    rng = np.random.default_rng(8)
    probs = []
    for i in range(40):
        t = rng.integers(0, 4, int(rng.integers(30, 150))).astype(np.uint8)
        q = t.copy()
        q[rng.integers(0, len(q), 2)] = rng.integers(0, 4, 2)
        if i % 3 == 0:
            q = np.delete(q, int(rng.integers(1, len(q) - 1)))
        elif i % 3 == 1:
            q = np.insert(q, int(rng.integers(1, len(q) - 1)), 2)
        probs.append((q, t, int(rng.integers(5, 60))))
    ours = BatchGlobal(OPT, torch.device("cpu"))
    ref = JaxBatchGlobal(ref_config.MemOptions())
    for p in probs:
        ours.submit(*p)
        ref.submit(*p)
    before = sw_global.traceback_fetches
    got = ours.run()
    assert sw_global.traceback_fetches > before
    assert got == ref.run()
    for (q, t, w), (score, cig) in zip(probs, got):
        assert (score, cig) == ksw.global2(q, t, MAT, OPT.o_del, OPT.e_del, OPT.o_ins, OPT.e_ins, w)
    assert ours.run() == []


def test_wrappers_use_plain_versions_for_cpu_tensors():
    qs, ts, qlens, tlens, ws = arrs = problems(9, 8, 64, 96)
    args = [torch.from_numpy(x) for x in arrs]
    s, z = global_z(*args, MAT_T, **GAPS)
    assert torch.equal(global_score(*args, MAT_T, **GAPS), s)
    ops, fi, fk = traceback(z, *args[2:], max_steps=160)
    ref = traceback_torch(z, *args[2:], max_steps=160)
    assert all(torch.equal(a, b) for a, b in zip((ops, fi, fk), ref))

