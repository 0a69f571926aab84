"""Engine: the SLAM state machine (bootstrap, tracking, mapping,
relocalization, loop closure) over one state of fixed-capacity tensors,
driven from the host."""

from .state import (SfMState, CameraParams, METRIC_FIELDS, init_state,
                    make_frame, state_from_numpy, state_to_numpy,
                    NOT_INITIALIZED, RUNNING, LOST)
from .step import SfMEngine, step_frame, run_pending_mapping
from .bootstrap import bootstrap_step
from .tracking import tracking_step
from .mapping import mapping_pass
from .reloc import reloc_step
from .loop import (LoopProbe, build_loop_probe, close_loop,
                   interpolate_corrections, retriangulate_landmarks)
