from .metrics import LogHistogram
from .trace import NULL_RECORDER, NoopRecorder, now_ns

__all__ = ["LogHistogram", "NULL_RECORDER", "NoopRecorder", "now_ns"]
