from .md5 import frame_md5, md5_lines
