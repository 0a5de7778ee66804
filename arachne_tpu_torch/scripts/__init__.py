"""Scripts of the port that run at scale or study the aligner, each the
jax-free twin of a script under the repository's ``scripts/``:

    python -m arachne_tpu_torch.scripts.make_scale_genome OUT.fa [--contigs] [--contig-len] [--seed]
    python -m arachne_tpu_torch.scripts.wide_device_check GENOME.fa.arx.npz
    python -m arachne_tpu_torch.scripts.scaling_study [--engine cuda]
    python -m arachne_tpu_torch.scripts.rfa_study [WORKDIR] [--engine cuda]

``scripts/seeding_microbench.py`` has no twin here: its question (batched
rank queries against the dependent seeding state machine) is answered by
``python -m arachne_tpu_torch.seeding_bench`` (K5 rank queries/s against
S1/S3 reads/s).
"""
