"""Edge-partitioned training: P destination-block partitions, in one
process or one process per card over ``torch.distributed``
(``kgat_tpu_torch.parallel.partition``, ``dp``, ``halo`` and
``multihost``)."""
