"""Profiler spans and the one device -> host read (``utils.stat``)."""

from zk_tpu_torch.utils.stat import span, to_host  # noqa: F401
