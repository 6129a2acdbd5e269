"""The port's synthetic data pipeline (``repro_torch.data.pipeline``): the
reference's configuration and properties (``tests/test_substrate.py``),
and the shapes and dtypes of the reference's batches for every kind.

torch cannot reproduce ``jax.random``'s threefry stream, so the values
differ from the reference's; the tests that compare the packages pass the
reference's batches into both.
"""

import dataclasses

import numpy as np
import pytest
import torch

import _torch_parity  # noqa: F401  (one torch thread a test process)
from repro.configs import get_smoke_config as ref_get_smoke
from repro.data import pipeline as ref_pipe
from repro_torch.configs import get_smoke_config
from repro_torch.data import pipeline as pipe
from repro_torch.data.pipeline import (DataConfig, shard_batch_size,
                                       synthetic_batch, synthetic_shard)

ARCH = "qwen2-0.5b"


def test_data_config_fields_and_defaults_match():
    def fields(cls):
        return [(f.name, f.default) for f in dataclasses.fields(cls)]

    assert fields(DataConfig) == fields(ref_pipe.DataConfig)


def test_shard_batch_size():
    assert shard_batch_size(DataConfig(global_batch=8, num_shards=4)) == 2
    with pytest.raises(ValueError):
        shard_batch_size(DataConfig(global_batch=8, num_shards=3))


def test_data_pipeline_deterministic_and_sharded():
    """The reference's property test on the port's stream."""
    cfg = get_smoke_config(ARCH)
    d4 = DataConfig(seed=3, global_batch=8, seq_len=16, num_shards=4)
    b1 = synthetic_batch(d4, cfg, step=5, device="cpu")
    b2 = synthetic_batch(d4, cfg, step=5, device="cpu")
    assert torch.equal(b1["tokens"], b2["tokens"])
    b3 = synthetic_batch(d4, cfg, step=6, device="cpu")
    assert not torch.equal(b1["tokens"], b3["tokens"])
    s2 = synthetic_shard(d4, cfg, step=5, shard=2, device="cpu")
    assert torch.equal(b1["tokens"][4:6], s2["tokens"])
    other = synthetic_batch(dataclasses.replace(d4, seed=4), cfg, 5, "cpu")
    assert not torch.equal(b1["tokens"], other["tokens"])


def test_shards_differ_and_tokens_cover_the_vocab():
    cfg = get_smoke_config(ARCH)
    d = DataConfig(seed=0, global_batch=64, seq_len=128, num_shards=2)
    a, b = (synthetic_shard(d, cfg, 0, i, "cpu")["tokens"] for i in (0, 1))
    assert not torch.equal(a, b)
    both = torch.cat([a, b])
    assert int(both.min()) == 0 and int(both.max()) == cfg.vocab - 1
    counts = np.bincount(both.flatten().numpy(), minlength=cfg.vocab)
    expected = both.numel() / cfg.vocab
    # uniform: every count within 6 sigma of the mean (a Poisson bound)
    assert np.abs(counts - expected).max() < 6 * np.sqrt(expected)


@pytest.mark.parametrize("arch", ["qwen2-0.5b", "internvl2-26b",
                                  "whisper-base", "mamba2-2.7b"])
def test_shapes_and_dtypes_match_reference(arch):
    """Keys, shapes and dtypes of every kind's batch equal the
    reference's: int32 tokens, the vlm's shortened by its prefix, f32
    frontend inputs of 0.1 x normal."""
    d = DataConfig(seed=1, global_batch=4, seq_len=48, num_shards=2)
    want = ref_pipe.synthetic_batch(d, ref_get_smoke(arch), 3)
    got = synthetic_batch(d, get_smoke_config(arch), 3, "cpu")
    assert sorted(got) == sorted(want)
    for k in want:
        assert tuple(got[k].shape) == want[k].shape, k
        assert str(got[k].dtype).removeprefix("torch.") == str(want[k].dtype)
    if "frontend" in got:
        assert abs(float(got["frontend"].std()) - 0.1) < 0.01


def test_batches_are_the_same_on_every_device():
    """The draws run on the CPU and move to the device: the stream does
    not depend on it (here, the CPU's batch equals the batch built for
    'cpu' twice over a different default generator state)."""
    cfg = get_smoke_config("whisper-base")
    d = DataConfig(seed=2, global_batch=2, seq_len=16)
    a = synthetic_batch(d, cfg, 1, "cpu")
    torch.manual_seed(123)
    torch.rand(10)
    b = synthetic_batch(d, cfg, 1, "cpu")
    assert all(torch.equal(a[k], b[k]) for k in a)
    assert pipe._generator(2, 1, 0).initial_seed() == \
        pipe._generator(2, 1, 0).initial_seed()


def test_the_card_is_the_default_device():
    if torch.cuda.is_available():
        pytest.skip("a card is present")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        synthetic_batch(DataConfig(), get_smoke_config(ARCH), 0)
