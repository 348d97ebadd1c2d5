from swtpu.ops.common import Q_PAD, T_PAD, pad_to_static, sentinel_pad_batch
from swtpu.ops.scan import sw_scores_scan

__all__ = [
    "Q_PAD",
    "T_PAD",
    "pad_to_static",
    "sentinel_pad_batch",
    "sw_scores_scan",
    "sw_scores_stream",
]


def __getattr__(name):
    # the Pallas kernel imports lazily so scan-only use never touches pallas
    if name == "sw_scores_stream":
        from swtpu.ops.pallas_stream import sw_scores_stream

        return sw_scores_stream
    raise AttributeError(name)
