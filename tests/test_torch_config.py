"""The port's SfMConfig equals the JAX package's field for field; the
FLAGSHIP preset is the JAX package's flagship with float32 features, and
SLICE the same with the dense BA solver."""

import dataclasses

import torch_port_util  # noqa: F401  (thread cap)

import __graft_entry__
from sfm_tpu.config import SfMConfig as JaxConfig
from sfm_tpu_torch.config import FLAGSHIP, SLICE, SfMConfig


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


def test_flagship_is_the_jax_flagship_with_float32_features():
    assert FLAGSHIP == dict(__graft_entry__.FLAGSHIP,
                            feature_dtype="float32", patch_int8=False)
    assert FLAGSHIP["ba_solver"] == "large"
