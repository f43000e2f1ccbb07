"""Training sessions: the solo :class:`SPBEngine` and the horizontally
fused :class:`FusedEngine`."""
from repro_torch.engine.engine import SPBEngine
from repro_torch.engine.fused import FusedEngine, stack_batches

__all__ = ["FusedEngine", "SPBEngine", "stack_batches"]
