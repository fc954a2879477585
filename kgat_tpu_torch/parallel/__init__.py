"""Edge-partitioned training: P destination-block partitions in one process
(``kgat_tpu_torch.parallel.partition``, ``dp`` and ``halo``)."""
