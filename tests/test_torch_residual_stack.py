"""The residual-stack kernel's grid plan, and its plain version against the
JAX package's scan at the flagship's width (CPU, f32).

The plan is plain Python that the CUDA kernel follows (ops/residual_stack.py:
plan, csrc/residual_stack.cu), so its invariants are checked here, at the
H100's 132 SMs: every output element belongs to exactly one block, the grid
fits on the card at once (a cooperative launch needs that), column strips
are whole float4 quads, and the shared memory is within a block's 227 KB."""

import numpy as np
import pytest
import jax

from multilingual_multimodal_speech_emotion_recognition_tpu.models import (
    classifier as jclf)
from multilingual_multimodal_speech_emotion_recognition_tpu_torch.models import (
    classifier as tclf)
from multilingual_multimodal_speech_emotion_recognition_tpu_torch.ops import (
    residual_stack as rs)

from torch_port_helpers import META, assert_close, bridge, j, perturb, t

H100_SMS = 132
FLAGSHIP_L, FLAGSHIP_D = 35, 512
STACK_TOL = 2e-5   # the JAX package's own bound for the Pallas stack


@pytest.mark.parametrize("D", [32, 512, 768])
@pytest.mark.parametrize("B", [1, 3, 4, 11, 128, 1000])
def test_plan_owns_each_element_once_and_fits_the_card(B, D):
    p = rs.plan(B, FLAGSHIP_L, D, H100_SMS)
    owners = np.zeros((B, D), np.int32)
    for block in range(p.blocks):
        for r0, r1, c0, c1 in p.tiles(block):
            assert r0 < r1 and c0 < c1
            owners[r0:r1, c0:c1] += 1
    assert (owners == 1).all()
    assert p.blocks <= H100_SMS * rs.BLOCKS_PER_SM
    assert p.col_width % 4 == 0 and 32 % (p.col_width // 4) == 0
    assert p.rows in rs.ROW_GROUP_SIZES and p.row_blocks <= p.row_groups
    assert 1 <= p.depth <= 2 * FLAGSHIP_L
    assert p.smem_bytes == rs.smem_bytes(p.rows, D, p.col_width, p.depth)
    assert p.smem_bytes <= 232_448


@pytest.mark.parametrize("B,rows,col_width,col_groups,row_blocks", [
    (4, 4, 8, 64, 1),      # one row group: the least work a block, 8 columns
    (128, 16, 32, 16, 8),  # 8 row groups x 16 column groups
    (300, 16, 16, 32, 4),  # blocks loop over several row groups
])
def test_plan_at_the_flagship_width(B, rows, col_width, col_groups, row_blocks):
    p = rs.plan(B, FLAGSHIP_L, FLAGSHIP_D, H100_SMS)
    assert (p.rows, p.col_width, p.col_groups, p.row_blocks) == (
        rows, col_width, col_groups, row_blocks)
    # the ring holds as many strips as fit beside the activation and partials
    assert rs.smem_bytes(rows, FLAGSHIP_D, col_width, p.depth + 1) > rs.MAX_SMEM


@pytest.mark.parametrize("B,D,col_width", [
    (4, 516, 8), (128, 516, 16),   # D=516 leaves the last column group ragged
    (1000, 512, 32),               # equal work at 8-32 columns: the widest
    (128, 32, 8), (4, 2048, 16),   # at D=2048 8-column groups outnumber the SMs
])
def test_plan_takes_each_column_width(B, D, col_width):
    """Shapes at which the plan picks each width, as tests/test_torch_cuda.py
    launches them."""
    p = rs.plan(B, FLAGSHIP_L, D, H100_SMS)
    assert p.col_width == col_width and p.col_groups == -(-D // col_width)


def test_plan_raises_on_what_does_not_fit():
    with pytest.raises(ValueError, match="no grid fits"):   # 64 strips of 32 > 8 SMs
        rs.plan(4, FLAGSHIP_L, 2048, 8)


@pytest.mark.parametrize("B", [1, 4])
def test_residual_stack_plain_matches_scan_at_flagship_width(B):
    L, D = FLAGSHIP_L, FLAGSHIP_D
    jp = jclf.init_classifier(jax.random.key(B), input_dim=64, num_labels=4,
                              num_layers=L, base_dim=D)
    # LN and bias leaves perturbed; the kernels keep the model's xavier init
    jlayers = perturb(jp["layers"], np.random.default_rng(B))
    for lin in ("block_lin1", "block_lin2"):
        jlayers[lin]["kernel"] = np.asarray(jp["layers"][lin]["kernel"])
    tlayers = bridge(jlayers, tclf.init_classifier(META, 64, 4, L, D)["layers"])
    x = np.random.default_rng(100 + B).standard_normal((B, D)).astype(np.float32)
    got = rs.residual_stack_plain(tlayers, t(x))
    want = jax.jit(lambda p, x: jclf._residual_stack(
        p, x, dropout_rate=0.0, dropout_key=None, deterministic=True))(
            jax.tree.map(j, jlayers), j(x))
    assert got.shape == (B, D)
    assert_close(got, want, STACK_TOL)
