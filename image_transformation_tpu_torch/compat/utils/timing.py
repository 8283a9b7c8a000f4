"""The reference ``utils.timing`` module on the port: ``StepTimer`` from
``core/timing.py`` (the reference's API and ``time_log.txt`` format, with
torch.profiler ranges)."""

from ...core.timing import StepTimer  # noqa: F401
