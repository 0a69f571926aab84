"""The port's SfMConfig equals the JAX package's field for field, and the
slice preset is the flagship with the dense solver and float32 features."""

import dataclasses

import torch_port_util  # noqa: F401  (thread cap)

import __graft_entry__
from sfm_tpu.config import SfMConfig as JaxConfig
from sfm_tpu_torch.config import SLICE, SfMConfig


def test_fields_and_defaults_match():
    ours = [(f.name, f.default) for f in dataclasses.fields(SfMConfig)]
    ref = [(f.name, f.default) for f in dataclasses.fields(JaxConfig)]
    assert ours == ref


def test_config_round_trips():
    cfg = JaxConfig(**__graft_entry__.FLAGSHIP)
    assert dataclasses.asdict(SfMConfig(**dataclasses.asdict(cfg))) == \
        dataclasses.asdict(cfg)
    assert SfMConfig().desc_words == cfg.desc_words == 16


def test_slice_is_flagship_with_dense_solver():
    expected = dict(__graft_entry__.FLAGSHIP, ba_solver="dense",
                    use_pallas_ba=False, feature_dtype="float32",
                    patch_int8=False)
    assert SLICE == expected
