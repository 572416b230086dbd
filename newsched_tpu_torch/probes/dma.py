"""The window-copy probe (reference: bench/exp_dma.py, exp_dma64.py,
exp_dma2.py): ``window_copy``, one templated kernel in csrc/probes.cu.

Tile t of the input is the window of rows [t*T, t*T + T + H) (K3's window:
its tile and H8 = 16 rows of halo); a block walks several tiles in order.
Variants:

- "dbuf": the window copied into shared memory by cp.async, double
  buffered: tile t+1's copies are issued before the wait on tile t
  (exp_dma.py's ``nslots=2``; at 128-1024 lanes a row, exp_dma2.py's
  per-row copy);
- "single": one slot, each window issued and waited on in turn
  (``nslots=1``, the no-overlap reference);
- "split": re and im as two 64-lane planes into two shared buffers,
  double buffered (exp_dma64.py), against one 128-lane window;
- "direct": no shared memory, each thread reads its 16-byte words of a
  (T, 512) tile from global memory (exp_dma2.py's auto-pipelined
  ``BlockSpec`` read).

Each tile writes its own first 8 rows into its own slot of the output,
(NT, 8, lanes): the TPU probes wrote one block from every tile, which on a
GPU, whose blocks run in no order, would check only one tile. The plain
version is the strided slice.
"""

from __future__ import annotations

import functools

import torch

from newsched_tpu_torch.ops.cuda import _build

OUT_ROWS = 8
VARIANTS = {"dbuf": 0, "single": 1, "split": 2, "direct": 3}
LANES = {"dbuf": (128, 256, 512, 1024), "single": (128,), "split": (128,),
         "direct": (512,)}
_SMEM_MAX = 232448
_SM_SMEM = 233472
_THREADS = 256


def window_copy_plain(x: torch.Tensor, T: int, H: int = 0,
                      xi: torch.Tensor | None = None) -> torch.Tensor:
    """The plain PyTorch version of ``window_copy``: the first 8 rows of
    each tile, (NT, 8, lanes); with ``xi`` (the split planes) re then im."""
    NT = (int(x.shape[0]) - H) // T
    tiles = x[:NT * T].reshape(NT, T, -1)[:, :OUT_ROWS]
    if xi is not None:
        tiles = torch.cat([tiles, xi[:NT * T].reshape(NT, T, -1)[:, :OUT_ROWS]],
                          dim=2)
    return tiles.contiguous()


def smem_bytes(variant: str, T: int, H: int, lanes: int) -> int:
    slots = {"dbuf": 2, "single": 1, "split": 2, "direct": 0}[variant]
    return slots * (T + H) * lanes * 4


@functools.lru_cache(maxsize=None)
def tiles_per_block(n_tiles: int, smem: int, sms: int) -> int:
    """Tiles a block walks: as few as fill every SM once at the blocks per
    SM that its shared memory allows."""
    per_sm = max(1, min(2048 // _THREADS, _SM_SMEM // (smem + 1024)))
    return -(-n_tiles // (sms * per_sm))


def window_copy(x: torch.Tensor, T: int, H: int = 0, *, variant: str = "dbuf",
                xi: torch.Tensor | None = None) -> torch.Tensor:
    """Copy every window of ``x`` ((NT*T + H, lanes) float32) as ``variant``
    does and return each tile's first 8 rows, (NT, 8, lanes). "split" takes
    the re plane as ``x`` and the im plane as ``xi``, each (NT*T + H, 64),
    and returns 128 lanes. A block walks as many tiles as make one wave of
    blocks. CPU tensors take the plain version; CUDA tensors launch
    ``window_copy_launch``."""
    if variant not in VARIANTS:
        raise ValueError(f"variant {variant!r} not in {tuple(VARIANTS)}")
    if (variant == "split") != (xi is not None):
        raise ValueError("the split variant takes both planes, x and xi")
    rows, width = (int(d) for d in x.shape)
    lanes = 2 * width if variant == "split" else width
    if lanes not in LANES[variant]:
        raise ValueError(f"{variant}: {lanes} lanes, the kernel is built for "
                         f"{LANES[variant]}")
    if variant == "direct" and H:
        raise ValueError("the direct read has no halo")
    NT = (rows - H) // T
    if T < OUT_ROWS or NT < 1:
        raise ValueError(f"tile {T}: need >= {OUT_ROWS} rows and one tile")
    smem = smem_bytes(variant, T, H, lanes)
    if smem > _SMEM_MAX:
        raise ValueError(f"{variant} tile {T}: {smem} bytes of shared memory, "
                         f"the H100 allows {_SMEM_MAX}")
    if x.device.type == "cpu":
        return window_copy_plain(x, T, H, xi)
    dev = x.device
    _build.check_tensor(x, "x", device=dev)
    if xi is not None:
        _build.check_tensor(xi, "xi", device=dev, shape=tuple(x.shape))
    G = tiles_per_block(
        NT, smem, torch.cuda.get_device_properties(dev).multi_processor_count)
    out = torch.empty((NT, OUT_ROWS, lanes), dtype=torch.float32, device=dev)
    with torch.cuda.device(dev):
        err = _build.lib().window_copy_launch(
            VARIANTS[variant], x.data_ptr(),
            None if xi is None else xi.data_ptr(), out.data_ptr(), rows, T, H,
            int(G), lanes, torch.cuda.current_stream(dev).cuda_stream)
    _build.check(err, "window_copy_launch")
    window_copy.launches += 1
    return out


window_copy.launches = 0
