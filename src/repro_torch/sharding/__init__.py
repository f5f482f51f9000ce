"""Execution across processes: the merge phase's one collective
(:mod:`repro_torch.sharding.merge`)."""
