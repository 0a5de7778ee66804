"""Multi-process data-parallel execution on torch.distributed.

The port of arachne_tpu/parallel/distributed.py.  The reference is
strictly single-node (goroutines + channels, SURVEY.md 5 "Distributed
communication backend: none").  The scale-out:

  * ``torch.distributed.init_process_group`` forms the process group (one
    process per card, or several on one card), told its coordinator
    address, world size and rank by the caller: nothing on a host
    announces a cluster;
  * the barcode-sorted stream is work-partitioned round-robin by barcode
    set: process ``i`` handles the sets whose index ``% num_processes ==
    i`` (runtime/checkpoint.py) — no communication on the input side,
    because barcodes are independent work units;
  * each process writes its own output shards (mirroring the reference's
    sharded BAMs — no output collective needed);
  * run statistics merge at the end with an allgather and a sum;
  * failure handling: a process that dies simply leaves its residue of
    barcode sets unprocessed; the claim manifests (runtime/checkpoint.py)
    record exactly which, so a re-run with any process count resumes only
    the missing work.

Every collective here moves a handful of host integers (a stats vector, a
generation number, a claim digest), so the group uses the gloo backend on
CPU tensors whatever device the engine runs on.  NCCL would need one card
per process and refuses two processes on one card; gloo needs neither.
"""

from __future__ import annotations

import os
from dataclasses import dataclass
from datetime import timedelta
from typing import Iterator, Optional

import numpy as np


@dataclass
class DistContext:
    process_index: int = 0
    process_count: int = 1
    initialized: bool = False


def collective_timeout() -> float:
    """Seconds any collective, and the group's forming, may take:
    ARACHNE_COLLECTIVE_TIMEOUT, 120 by default."""
    return float(os.environ.get("ARACHNE_COLLECTIVE_TIMEOUT", 120))


def init_distributed(
    coordinator: Optional[str] = None,
    num_processes: Optional[int] = None,
    process_id: Optional[int] = None,
) -> DistContext:
    """Form the process group (no-op for single-process runs).

    ``coordinator`` is ``host:port``, where process 0 listens; without one
    (nor ARACHNE_COORDINATOR) the run is single-process.  With one, the
    process count and this process's id are required, and a group that
    does not form within ``collective_timeout()`` (a peer that never
    starts) raises: it never falls back to a single process."""
    if coordinator is None:
        coordinator = os.environ.get("ARACHNE_COORDINATOR")
    if not coordinator:
        return DistContext()
    if num_processes is None or process_id is None:
        raise ValueError(
            f"coordinator {coordinator} given without --num-processes and --process-id"
        )
    if num_processes < 1 or not 0 <= process_id < num_processes:
        raise ValueError(
            f"process id {process_id} is not in [0, {num_processes}): "
            "--process-id counts from 0 below --num-processes"
        )
    import torch.distributed as dist

    dist.init_process_group(
        "gloo",
        init_method=f"tcp://{coordinator}",
        world_size=num_processes,
        rank=process_id,
        timeout=timedelta(seconds=collective_timeout()),
    )
    return DistContext(
        process_index=dist.get_rank(),
        process_count=dist.get_world_size(),
        initialized=True,
    )


def partition_work(items: Iterator, ctx: DistContext) -> Iterator:
    """Round-robin assignment of independent work items to this process.

    The production barcode-stream partition lives in
    runtime.checkpoint.CheckpointedStream (same i %% P == p rule, fused
    with resume skipping); this helper serves ad-hoc callers."""
    for i, item in enumerate(items):
        if i % ctx.process_count == ctx.process_index:
            yield item


def _with_timeout(fn, timeout_s: float, what: str):
    """Run fn() on a daemon thread; None if it does not finish in time.

    The end-of-run collectives can block if a peer died mid-run; a bounded
    wait lets the survivors finish their own shards, report local stats,
    and exit cleanly so a re-run with the surviving topology (claim-based
    manifests accept any process count) picks up the dead host's residue."""
    import threading

    box = []

    def run():
        try:
            box.append(fn())
        except Exception as e:  # noqa: BLE001 - surfaced as a warning
            box.append(e)

    t = threading.Thread(target=run, daemon=True)
    t.start()
    t.join(timeout_s)
    if not box or isinstance(box[0], Exception):
        detail = f": {box[0]}" if box else " (timeout)"
        print(
            f"WARNING: {what} did not complete{detail} — a peer process "
            f"likely died; continuing with local values. Re-run with the "
            f"surviving process count to finish its share.",
            flush=True,
        )
        return None
    return box[0]


def _allgather(values) -> np.ndarray:
    """(process_count, n) int64: every process's ``values``, by rank."""
    import torch
    import torch.distributed as dist

    t = torch.from_numpy(np.array(values, dtype=np.int64).reshape(-1))
    parts = [torch.empty_like(t) for _ in range(dist.get_world_size())]
    dist.all_gather(parts, t)
    return torch.stack(parts).numpy()


def allreduce_stats(values: np.ndarray, ctx: DistContext) -> np.ndarray:
    """Sum an int64 stats vector across all processes; identity for
    single-process runs.  Falls back to the local vector (with a loud
    warning) if the collective cannot complete because a peer died."""
    if not ctx.initialized or ctx.process_count == 1:
        return values
    out = _with_timeout(
        lambda: _allgather(values).sum(axis=0),
        collective_timeout(),
        "final stats allreduce",
    )
    return values if out is None else out


def allreduce_max_int(value: int, ctx: DistContext) -> int:
    """Max of an int across all processes; identity for single-process
    runs.

    Used to agree on the checkpoint generation before any manifest is
    written: a slow host's glob could otherwise see a fast peer's fresh
    manifest and compute generation max+1, mis-keying its claims."""
    if not ctx.initialized or ctx.process_count == 1:
        return value
    out = _with_timeout(
        lambda: int(_allgather([value]).max()),
        collective_timeout(),
        "checkpoint generation agreement",
    )
    if out is None:
        # unlike the end-of-run stats merge, generation agreement CANNOT
        # fall back to local values (the fleet would split across
        # generations); nothing has been written yet, so abort cleanly
        raise RuntimeError(
            "generation agreement collective failed — a peer process died "
            "during startup; relaunch the fleet"
        )
    return out


def assert_uniform_int(value: int, ctx: DistContext, what: str) -> None:
    """Fail loudly unless every process reports the same value.

    Used for checkpoint claim-digest agreement: each resuming host globs
    sibling manifests independently, so shared-filesystem visibility lag
    (NFS attribute caching) or a host that saved to a non-shared path can
    leave one host missing a peer's claims — it would silently re-run that
    peer's completed sets and the merged output would carry duplicates.
    Nothing has been written at agreement time, so aborting is safe."""
    if not ctx.initialized or ctx.process_count == 1:
        return
    out = _with_timeout(
        lambda: _allgather([value])[:, 0],
        collective_timeout(),
        f"{what} agreement",
    )
    if out is None:
        raise RuntimeError(
            f"{what} agreement collective failed — a peer process died "
            "during startup; relaunch the fleet"
        )
    if not (out == out[0]).all():
        raise RuntimeError(
            f"hosts disagree on {what} ({out.tolist()}): a resuming host "
            "cannot see every sibling manifest (shared-filesystem lag or a "
            "manifest saved to a non-shared path). Re-check the checkpoint "
            "path is on a shared filesystem and relaunch; resuming now "
            "would re-run another host's completed sets as duplicates."
        )


def shutdown_distributed(ctx: DistContext) -> None:
    """Destroy the process group at the end of a run (no-op for
    single-process runs).  Left to the interpreter's exit, the group's C++
    threads are destroyed while still joinable and the process aborts
    ("terminate called without an active exception", exit -6) after its
    run has succeeded."""
    if ctx.initialized:
        import torch.distributed as dist

        dist.destroy_process_group()


def shard_suffix(ctx: DistContext) -> str:
    """Per-host output shard suffix (empty for single-host runs)."""
    if ctx.process_count == 1:
        return ""
    return f".host{ctx.process_index:03d}"
