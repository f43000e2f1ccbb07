"""Schedule-driven pipeline parallelism: the per-tick schedule tables
(``schedules``), the stage partition of a model (``stage``) and the
interpreter that runs a table on a rank's stage (``runtime``)."""
from repro_torch.dist.pipeline import runtime, schedules, stage  # noqa: F401
from repro_torch.dist.pipeline.runtime import (  # noqa: F401
    pipeline_apply, pipeline_train_grads, run_schedule,
    sequential_reference)
from repro_torch.dist.pipeline.schedules import (  # noqa: F401
    Schedule, StashPlan, WorkItem, bubble_fraction, bubble_fraction_of,
    build, gpipe, gpipe_forward, max_in_flight, one_f_one_b, render,
    spb_truncate, stash_plan, validate)
