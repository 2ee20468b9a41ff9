"""The named spans of a decode.

`span(name)` is torch.profiler's `record_function`: a range in a
profiler's trace, and a few microseconds of host time when no profiler
runs.  Every span opens through this one function, looked up at the
call: the frame step's stages and its upload (`runtime/fused.py`), the
pack and the read-back (`runtime/pipeline.py`, `runtime/multistream.py`)
and the parse (`decoder/frame.py`).  So a tool swaps `spans.span` for a
clock and times them all (`tools/profile_decode.stage_clock`).  No span
opens inside another.
"""

from torch.profiler import record_function


def span(name: str):
    return record_function(name)
