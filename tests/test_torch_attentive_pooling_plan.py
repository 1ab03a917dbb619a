"""The bf16 pooling kernel's plan and the pooling routes (CPU).

The plan is plain Python that the CUDA kernel follows
(ops/attentive_pooling.plan, csrc/attentive_pooling.cu:pool_wgmma), so its
invariants are checked here at the H100's 132 SMs: every frame of every
batch row is read by exactly one block, a tile holds at most 64 rows,
clusters stay within the portable 8 blocks, and the shared memory is within
a block's 227 KB."""

import numpy as np
import pytest
import torch

from multilingual_multimodal_speech_emotion_recognition_tpu_torch.ops import (
    attentive_pooling as ap)

H100_SMS = 132
POOL_A = (199, 768, 128)   # (S, D, H) at the flagship's audio pooling site


@pytest.mark.parametrize("S", [1, 7, 32, 199, 1499])
@pytest.mark.parametrize("B", [1, 4, 128, 300])
def test_plan_covers_every_frame_once_and_fits(B, S):
    for D in (64, 768, 1536):
        for H in (32, 128, 256):
            p = ap.plan(B, S, D, H, H100_SMS)
            seen = np.zeros((B, S), np.int32)
            for block in range(p.blocks):
                for b, s0, s1 in p.pieces(block):
                    assert s0 < s1
                    seen[b, s0:s1] += 1
            assert (seen == 1).all(), (B, S, D, H)
            assert p.rows * p.seg <= ap.TILE_ROWS and p.seg & (p.seg - 1) == 0
            assert 1 <= p.cluster <= ap.MAX_CLUSTER
            assert p.cluster * p.tiles >= p.tiles_per_row
            assert p.rows == 1 or (p.tiles_per_row == 1 and p.cluster == 1)
            assert p.chunk in ap.CHUNKS and 1 <= p.depth <= ap.MAX_DEPTH
            assert p.smem_bytes == ap.smem_bytes(D, H, p.chunk, p.depth, p.cluster)
            assert p.smem_bytes <= ap.MAX_SMEM


def test_plan_spreads_a_small_batch_over_many_blocks():
    p = ap.plan(4, *POOL_A, H100_SMS)
    assert p.blocks > 4 and p.cluster > 1


def test_plan_covers_the_card_at_b128():
    assert ap.plan(128, *POOL_A, H100_SMS).blocks >= H100_SMS


@pytest.mark.parametrize("B,cluster,tiles", [(4, 4, 1), (128, 2, 2), (300, 1, 4)])
def test_plan_takes_the_fewest_blocks_per_row_that_cover_the_card(B, cluster, tiles):
    p = ap.plan(B, *POOL_A, H100_SMS)
    assert (p.cluster, p.tiles, p.chunk) == (cluster, tiles, 128)


@pytest.mark.parametrize("B,rows", [(128, 1), (300, 2), (4000, 2)])
def test_plan_packs_short_rows_only_past_the_card(B, rows):
    p = ap.plan(B, 32, 768, 128, H100_SMS)
    assert (p.seg, p.rows, p.cluster) == (32, rows, 1)


def test_plan_raises_where_nothing_fits():
    with pytest.raises(ValueError, match="no bf16 plan"):
        ap.plan(4, 199, 2048, 256, H100_SMS)   # a 256 KB tile of x


def test_routes():
    bf16, f32 = torch.bfloat16, torch.float32
    assert ap.ROUTES[(bf16, f32)] == "f32"      # rounding f32 W1 to bf16 would change it
    assert ap.ROUTES[(bf16, bf16)] == "bf16"
    assert ap.ROUTES[(f32, f32)] == ap.ROUTES[(f32, bf16)] == "f32"
    assert ap.route(bf16, bf16, 768, 0) == "bf16"
    assert ap.route(bf16, f32, 768, 0) == "f32"
    assert ap.route(bf16, bf16, 36, 0) == "f32"   # rows of 72 bytes: no tensor map
    assert ap.route(bf16, bf16, 768, 8) == "f32"  # x not 16-byte aligned
