"""arachne-tpu-torch: the arachne-tpu aligner on PyTorch and CUDA (Hopper).

A second package beside ``arachne_tpu``, which stays the reference.  The
host layers of the reference import no JAX (``index``, ``align``, ``rfa``,
``io``, ``runtime``, ``native``, ``config``, ``utils``) and are reused by
import; what touched JAX is rewritten here:

  device.py        device resolution, the card probe, kernel timing
  ops/             the device DP batchers and device seeding (fm_rank,
                   fm_seed), each with a plain PyTorch version and a
                   hand-written CUDA kernel (ops/csrc/*.cu, sm_90a)
  ops/engine.py    TorchEngine, the batched candidate-generation engine
  cli.py           the ``align`` command plus host subcommands
  measure.py       timed runs of the align main path
  seeding_bench.py rank-query and seeding throughput (kernel K5's entry point)

Importing this package never imports ``jax``, ``arachne_tpu.ops``,
``arachne_tpu.parallel`` or ``arachne_tpu.cli``.
"""

from arachne_tpu import __version__

__all__ = ["__version__"]
