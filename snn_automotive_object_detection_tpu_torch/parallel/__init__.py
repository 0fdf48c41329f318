"""Multi-process data parallelism on ``torch.distributed``: the process
group and the rank's device (:mod:`.mesh`), the collectives
(:mod:`.collectives`) and a CPU dry run of one data-parallel step
(:mod:`.dryrun`)."""
