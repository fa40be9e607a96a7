"""The mask-pack kernel's route planner, from the CPU: which route and grid
each shape the port packs takes, and that the grid writes every word
exactly once under the kernels' index maps (``csrc/mask_pack.cu``).  The
kernels themselves run on the card (``tests/test_torch_cuda.py -k
mask_pack``).
"""

import numpy as np
import pytest
import torch

from repro_torch.kernels.mask_compress import ops as mc

H100_SMS = 132
# one (layer, slot) k/v block of llama3.2-1b's pool: max_len x 8 kv heads x 64,
# max_len = prompt + gen + 1 (prompt 32 or 4096, gen 16)
DECODE_BLOCK, LONG_BLOCK = 49 * 8 * 64, 4113 * 8 * 64


def _words_written(p: mc.Plan, n_words: int, elem_bytes: int) -> np.ndarray:
    """Every word index the plan's grid stores, in the kernels' index maps:
    the stream route's warp w visits steps w, w + warps, ... of the
    ceil(n_words / 32) steps; in a step, lane l stores word 32*step + (l %
    lanes_per_word) * groups + l // lanes_per_word; the lane route's warp w
    stores word w."""
    warps = p.ctas * mc.THREADS // 32
    if p.route == "lane":
        return np.arange(warps)
    steps = -(-n_words // 32)
    lanes_per_word = 32 // (16 // elem_bytes)
    groups = 32 // lanes_per_word
    visits = -(-steps // warps)
    step = np.arange(warps)[:, None] + warps * np.arange(visits)[None, :]
    step = step[step < steps]
    lane = np.arange(32)
    in_step = (lane % lanes_per_word) * groups + lane // lanes_per_word
    return (step[:, None] * 32 + in_step[None, :]).reshape(-1)


def _assert_covers_once(p: mc.Plan, n_blocks: int, block_len: int, elem_bytes: int) -> None:
    n_words = n_blocks * -(-block_len // 32)
    got = _words_written(p, n_words, elem_bytes)
    got = got[got < n_words]  # the kernels guard the ragged end
    assert got.size == n_words
    assert np.array_equal(np.sort(got), np.arange(n_words))


@pytest.mark.parametrize("n_blocks,block_len,ctas", [
    (64, DECODE_BLOCK, 196),   # prompt-32 decode tick: 16 layers x 4 slots
    (16, DECODE_BLOCK, 49),    # prompt-32 install row: 16 layers x 1 slot
    (64, LONG_BLOCK, 528),     # 4096-token decode tick
    (16, LONG_BLOCK, 528),     # 4096-token install row
])
@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float16, torch.float32])
def test_kv_leaves_take_the_stream_route(n_blocks, block_len, ctas, dtype):
    elem = mc._ELEM_BYTES[dtype]
    p = mc.plan(n_blocks, block_len, elem, True, H100_SMS)
    # 32 words a warp step, 8 warps a CTA, at most 4 CTAs per SM
    assert p == mc.Plan("stream", ctas) and ctas <= mc.STREAM_CTAS_PER_SM * H100_SMS
    _assert_covers_once(p, n_blocks, block_len, elem)


@pytest.mark.parametrize("shape", [(777,), (4096,), (1000,), (10, 100), (2, 2048), (3, 33),
                                   (7, 1000), (1, 32), (5, 288)])
@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float16, torch.float32])
def test_sweep_and_ragged_shapes(shape, dtype):
    """The sweep's examples (1-D, as the port packs them: 777, 4096 and
    1000 values), ragged lengths, one word, and a partial last step."""
    *lead, block_len = shape
    n_blocks, elem = int(np.prod(lead)), mc._ELEM_BYTES[dtype]
    x = torch.zeros(shape, dtype=dtype)
    p = mc.plan(n_blocks, block_len, elem, x.data_ptr() % 16 == 0, H100_SMS)
    assert p.route == ("stream" if block_len % 32 == 0 else "lane")
    _assert_covers_once(p, n_blocks, block_len, elem)


@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float16, torch.float32])
def test_a_misaligned_view_takes_the_lane_route(dtype):
    base = torch.zeros(4 * 1024 + 1, dtype=dtype)
    view = base[1:].reshape(4, 1024)  # contiguous, one value past a 16-byte boundary
    assert view.is_contiguous() and view.data_ptr() % 16 != 0
    elem = mc._ELEM_BYTES[dtype]
    p = mc.plan(4, 1024, elem, view.data_ptr() % 16 == 0, H100_SMS)
    assert p == mc.Plan("lane", 16)  # 128 words, a warp each
    _assert_covers_once(p, 4, 1024, elem)
    # aligned, the same shape streams
    assert mc.plan(4, 1024, elem, True, H100_SMS).route == "stream"


def test_empty_operands_plan_no_launch():
    assert mc.plan(0, 1024, 2, True, H100_SMS).ctas == 0
    assert mc.plan(5, 0, 2, True, H100_SMS).ctas == 0
    assert mc.plan(0, 33, 4, True, H100_SMS).ctas == 0


def test_fp16_packs_on_the_cpu_as_bf16_does():
    """fp16 takes the kernels' 16-bit magnitude test; on the CPU the plain
    version gives what the card must."""
    vals = [0.0, -0.0, float("nan"), float("inf"), float("-inf"), 2.0**-20, -(2.0**-20), 1.5]
    x = torch.tensor(vals * 4, dtype=torch.float16).reshape(1, 32)
    words = mc.mask_pack(x)
    bits = (x.float() != 0).numpy()[0]
    assert int(words[0, 0]) == sum(1 << i for i in range(32) if bits[i])
    assert torch.equal(words, mc.mask_pack(x.to(torch.bfloat16)))
