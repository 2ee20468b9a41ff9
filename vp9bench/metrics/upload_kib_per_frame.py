"""upload_kib_per_frame: KiB the program's uploader sent to the device in
the traced stretch (`Uploader.sent_bytes`), per frame delivered in it."""

from vp9bench.metrics import per_frame


def read(run):
    tr = run.trace
    d = None if tr is None else tr.delta("sent_bytes")
    return per_frame(run, None if d is None else d / 1024)
