"""The launch plan of the generating chain kernels K5 and K6, and past
128 lanes of K3 too (``ops/cuda/fm_chain.py`` ``gen_plan``,
``wide_plan``, ``_handoff_buffers``) and the
counters of their four-lane row source (``csrc/fm_chain.cu`` ``GenRows``),
on the CPU: the plan at the flagship's rows and over its 4 and 8 shards,
the tile-64 junction planned, each launch's handoff memory its own, a
shape the plan cannot take raising with its name, and the four-lane
generator counting every element as ``gauss`` and the plain noise
version do. The kernels themselves run only on the card (chip_smoke.py
phases 13, 25, 26, 41)."""

import numpy as np
import pytest
import torch

from newsched_tpu_torch.ops.cuda import fm_chain, noise

W, A, L = 128, 65, 16  # the flagship's lanes, audio taps and arm taps
J = A + L - 1          # a tile's junction: rows folded before its first
ROWS = 32768           # a batch of planes rows at M = 64


@pytest.mark.parametrize("nd", [1, 4, 8])
@pytest.mark.parametrize("tile", [64, 128, 256])
def test_flagship_plan(nd, tile):
    """At the flagship's rows and over its 4 and 8 shards (K6's one grid),
    at every tile the phases check, tile 64 (shorter than the junction)
    included: min(tile, J) rows published a tile, and the launch's own
    buffer of them followed by the ticket and one flag a tile."""
    blocks = nd * (ROWS // nd // tile)
    plan = fm_chain.gen_plan(W, tile, blocks, A, L)
    assert plan == (blocks, tile, min(tile, J))
    hand, flags = fm_chain._handoff_buffers(plan, W, "meta")
    assert hand.shape == (blocks * plan.hand_rows * W,)
    assert hand.dtype == torch.float32
    assert flags.shape == (blocks + 1,) and flags.dtype == torch.int32


def test_each_launch_has_its_own_flags():
    """No two launches share handoff memory: each call's rows and flags
    are one allocation made for it (on the stream it runs on)."""
    plan = fm_chain.gen_plan(W, 64, 4, A, L)
    h1, f1 = fm_chain._handoff_buffers(plan, W, "cpu")
    h2, f2 = fm_chain._handoff_buffers(plan, W, "cpu")
    assert h1.untyped_storage().data_ptr() != h2.untyped_storage().data_ptr()
    assert f1.untyped_storage().data_ptr() == h1.untyped_storage().data_ptr()
    assert f2.untyped_storage().data_ptr() == h2.untyped_storage().data_ptr()


@pytest.mark.parametrize("w", [w for w in fm_chain.WIDTHS if w != W])
def test_wide_instances_hand_over_the_junction(w):
    """Past 128 lanes every chain kernel hands its junction over
    (csrc/fm_chain.cu chain_tile_wide): at the flagship's batch of 16384
    rows and tile of 128, a block the junction and a block a tile; a slot
    a block holding Y of its last row, its last A-1 aud rows of M and (K5,
    K6) its last L-1 input rows; K5's and K6's rings of a pass's rows (64
    at M = 128, 32 up to M = 448, 16 past it) + L-1, in shared memory up
    to M = 256, else in device memory; the flags the ticket and one a
    block; the
    tile fitted to the block's shared memory (_chain_smem, _fit_tile)
    within _SMEM_MAX, as at tile 64."""
    M, tiles = w // 2, 16384 // 128
    rows = 16 if M >= 512 else 64 if M == 128 else 32
    assert fm_chain.wide_rows(M // 64) == rows
    tile = fm_chain._fit_tile(128, w, A, L, 8, 8)
    assert tile == 128
    smem = fm_chain._chain_smem(tile, A, L, 1, 8, w)
    ring = (rows + L - 1) * w
    on_chip = M <= 256
    assert fm_chain.ring_on_chip(M // 64) == on_chip
    assert smem == ((rows + 1) * w + tile // 8 * M + A
                    + (ring if on_chip else 0)) * 4 <= fm_chain._SMEM_MAX
    assert fm_chain._chain_smem(64, A, L, 1, 8, w) < smem
    for gen in (False, True):
        plan = (fm_chain.gen_plan(w, tile, tiles, A, L) if gen else
                fm_chain.wide_plan(w, tile, tiles, A, L, False))
        hx = L - 1 if gen else 0
        assert plan == (tiles + 1, tile, A - 1, hx,
                        rows + L - 1 if gen and not on_chip else 0,
                        w + (A - 1) * M + hx * w)
        hand, flags = fm_chain._handoff_buffers(plan, w, "meta")
        assert hand.shape == ((tiles + 1) * (plan.slot + plan.ring_rows * w),)
        assert hand.dtype == torch.float32
        assert flags.shape == (tiles + 2,) and flags.dtype == torch.int32
    with pytest.raises(ValueError, match="wide_plan: 0 tiles of 128 rows"):
        fm_chain.wide_plan(w, 128, 0, A, L, False)


@pytest.mark.parametrize("blocks,tile", [(0, 128), (4, 0)])
def test_an_empty_grid_raises(blocks, tile):
    with pytest.raises(ValueError, match=f"gen_plan: {blocks} blocks of "
                                         f"{tile} rows"):
        fm_chain.gen_plan(W, tile, blocks, A, L)


def _gen4_counters(g0: int, sr0: int, n: int, width: int):
    """gen4's counter words for rows sr0 .. sr0 + n - 1, four lanes at a
    time: c0 = (sr & 63) W + k + j from the row's sr >> 6, the group g0 +
    (sr >> 6) as two 32-bit words."""
    sr = np.arange(sr0, sr0 + n, dtype=np.int64)[:, None]
    k = np.arange(0, width, 4, dtype=np.int64)[None, :, None]
    j = np.arange(4, dtype=np.int64)[None, None, :]
    q = sr >> 6
    c0 = ((sr & 63) * width)[:, :, None] + k + j
    g = (np.int64(g0) + q)[:, :, None] + 0 * (k + j)
    return (c0.reshape(n, width) & 0xFFFFFFFF,
            (g & 0xFFFFFFFF).reshape(n, width),
            ((g >> 32) & 0xFFFFFFFF).reshape(n, width), g.reshape(n, width))


@pytest.mark.parametrize("g0", [0, 5, (1 << 32) - 2, -3])
def test_gen4_counts_as_gauss(g0):
    """The four-lane generator's counters, over rows of either sign, are
    the plain noise version's (ops/cuda/noise.py ``_counters``, which
    repeats philox.cuh ``gauss``)."""
    got = _gen4_counters(g0, -J - 64, 300, W)
    want = noise._counters(g0, 300, W, "cpu", row0=-J - 64)
    for a, b in zip(got[:3], want[:3]):
        np.testing.assert_array_equal(a, (b & 0xFFFFFFFF).numpy())
    np.testing.assert_array_equal(got[3], want[3].numpy())


@pytest.mark.parametrize("nd", [4, 8])
def test_one_base_serves_every_shard(nd):
    """K6 counts its rows from the first shard's base: row sr of shard d
    (sr - d n of its own rows, from its base g0 + d n / 64) has the group
    and index the launch's row sr has, so a block's junction may come
    from the shard before."""
    n = ROWS // nd
    g0 = 7
    rows = torch.arange(-J, nd * n, 97)
    for d in range(nd):
        for sr in rows.tolist():
            local = sr - d * n
            g_d = g0 + d * n // 64 + (local >> 6)
            assert g_d == g0 + (sr >> 6) and (local & 63) == (sr & 63)
    a = noise.gaussian_rows_plain(g0, n_rows=2 * 64, width=8, seed=0,
                                  device="cpu", row0=n - 64)
    b = noise.gaussian_rows_plain(g0 + n // 64, n_rows=2 * 64, width=8,
                                  seed=0, device="cpu", row0=-64)
    assert torch.equal(a, b)


def test_window_cut_anchors_once():
    """``probes/stages.py split`` cuts ``csrc/fm_chain.cu`` after a tile's
    window at one anchor, which must be there once."""
    from newsched_tpu_torch.ops.cuda import _build
    from newsched_tpu_torch.probes import stages

    anchor, cut = stages._WINDOW_CUT
    assert (_build.CSRC / "fm_chain.cu").read_text().count(anchor) == 1
    assert cut.startswith("#if STAGE < 2") and "return;" in cut


def test_wide_cut_anchors_once():
    """``probes/stages.py wide`` cuts ``csrc/fm_chain.cu``'s wide routine at
    anchors of its handoff form, each of which must be there once, and
    each cut sits behind STAGE."""
    from newsched_tpu_torch.ops.cuda import _build
    from newsched_tpu_torch.probes import stages

    text = (_build.CSRC / "fm_chain.cu").read_text()
    cuts = stages._WIDE_FORMS["handoff"]
    assert [text.count(anchor) for anchor, _, _ in cuts] == [1] * len(cuts)
    assert all("STAGE" in before for _, before, _ in cuts)
