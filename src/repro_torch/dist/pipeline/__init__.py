"""Schedule-driven pipeline parallelism: so far the per-tick schedule
tables (``schedules``), which the roofline's pipeline terms read."""
from repro_torch.dist.pipeline import schedules  # noqa: F401
from repro_torch.dist.pipeline.schedules import (  # noqa: F401
    Schedule, StashPlan, WorkItem, bubble_fraction, bubble_fraction_of,
    build, gpipe, gpipe_forward, max_in_flight, one_f_one_b, render,
    spb_truncate, stash_plan, validate)
