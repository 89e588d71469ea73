"""ops/nn.no_tf32 across threads: cuDNN's TF32 flag is global to the
process, and the port's convolutions turn it off from several threads at
once (request threads encoding references, the batcher, autograd's
backward, a data loader). While any thread is inside a block the flag stays
off, and the last block to close restores the flag as the first found it;
onnxtorch.interp.highest_precision shares the count."""

import threading

import pytest
import torch

from smalltts_tpu_torch.onnxtorch.interp import highest_precision
from smalltts_tpu_torch.ops import nn


@pytest.fixture(autouse=True)
def restore_flag():
    before = torch.backends.cudnn.allow_tf32
    yield
    torch.backends.cudnn.allow_tf32 = before


def run_interleaved(first, second):
    """Thread A opens `first`, thread B opens `second`, A closes, B reads the
    flag inside its block, B closes. Returns (B's reading, the flag after)."""
    a_in, b_in, a_out = threading.Event(), threading.Event(), threading.Event()
    seen = {}

    def a():
        with first():
            a_in.set()
            b_in.wait(10)
        a_out.set()

    def b():
        a_in.wait(10)
        with second():
            b_in.set()
            a_out.wait(10)
            seen["inside"] = torch.backends.cudnn.allow_tf32

    threads = [threading.Thread(target=a), threading.Thread(target=b)]
    for t in threads:
        t.start()
    for t in threads:
        t.join(10)
    return seen["inside"], torch.backends.cudnn.allow_tf32


@pytest.mark.parametrize("start", [True, False])
@pytest.mark.parametrize("pair", ["no_tf32", "with_highest_precision"])
def test_interleaved_blocks_keep_tf32_off_and_restore_it(start, pair):
    torch.backends.cudnn.allow_tf32 = start
    second = nn.no_tf32 if pair == "no_tf32" else highest_precision
    inside, after = run_interleaved(nn.no_tf32, second)
    assert inside is False  # A's exit must not turn TF32 back on inside B's block
    assert after is start  # the last block out restores what the first found


def test_nested_blocks_in_one_thread():
    torch.backends.cudnn.allow_tf32 = True
    with nn.no_tf32():
        with nn.no_tf32():
            assert torch.backends.cudnn.allow_tf32 is False
        assert torch.backends.cudnn.allow_tf32 is False
    assert torch.backends.cudnn.allow_tf32 is True
    with pytest.raises(ValueError):
        with nn.no_tf32():
            raise ValueError("the flag is restored on the way out")
    assert torch.backends.cudnn.allow_tf32 is True
