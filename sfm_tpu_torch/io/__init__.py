"""Host-side I/O: frame sources, point-cloud export (C++ runtime or
numpy), engine-state checkpoints, and the TUM dataset format."""

from .ply import PointCloud, read_ply
from .video import (FrameSource, ImageDirSource, NativeY4MSource,
                    NpyStackSource, Y4MSource, open_source, to_gray)
from .checkpoint import save_state, load_state
