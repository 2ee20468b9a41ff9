"""The named spans of a decode.

`span(name)` is torch.profiler's `record_function`: a range in a
profiler's trace, and a few microseconds of host time when no profiler
runs.  Every span opens through this one function, looked up at the
call, so a tool swaps `spans.span` for a clock and times them
(`tools/profile_decode.stage_clock`).  Two families:

  vp9.*  the work of a decode: the parse (`decoder/frame.py`), the pack
         and the read-back (`runtime/pipeline.py`, `runtime/multistream.py`),
         the frame step's stages and its upload (`runtime/fused.py`);
  api.*  the entry points a caller calls: `codec.vpx_codec_decode` and
         `codec.vpx_codec_get_frame`, `DecodedFrame.visible_planes`
         (`decoder/frame.py`, which `codec.Image.planes` reaches), and
         `BatchedTorchDecoder.decode_round` and the flush of its `drain`
         (`runtime/multistream.py`).

No span opens inside another of its family; an api.* span encloses the
vp9.* spans of the work it calls.  So the time inside an api.* span and
outside every vp9.* span is the program's own glue around the work.
"""

from torch.profiler import record_function


def span(name: str):
    return record_function(name)
