"""Fused FPN level through the hand-written CUDA kernel (K5).

Replaces ``ops/pallas_fpn.py`` (``fpn_level_pallas`` with its
``_fpn_level_kernel``, sequenced by ``fpn_pallas_apply``). One launch per
level computes

    merged_l = (C_l @ W_lat + b_lat) + upsample2x_nearest(merged_{l+1})
    P_l      = conv3x3(merged_l) + b_out          (zero padding)

and the merged map never makes a round trip through device memory between
the two convolutions. The kernel is ``csrc/fpn_level.cu``;
:func:`fpn_level_plain` beside it is its plain PyTorch version and repeats
the TPU kernel's bf16 rounding sequence step by step:

  * lateral: bf16 x bf16 products accumulated in f32 over Cin, rounded to
    bf16; ``+ b_lat`` as a bf16 add (rounded); ``+ merged_{l+1}[y // 2,
    x // 2]`` as a bf16 add (rounded again);
  * the 3x3 conv sees zeros outside the image (not ``b_lat``);
  * outer: 9 taps x 256 channels accumulated in f32, rounded to bf16 once,
    then ``+ b_out`` as a bf16 add;
  * the coarser map has ``ceil(H / 2) x ceil(W / 2)`` pixels, so odd sizes
    work; the finest level stores no merged map.

A CPU tensor takes the plain version; a CUDA tensor launches the kernel
(bf16 maps, 256 FPN channels, Cin a multiple of 32) or raises. The kernel
reads both weights by TMA as the K-major B of its products, so the wrapper
hands it ``wlat`` and each tap of ``wout`` transposed ([output, input]
channels): one copy each, as the cast to bf16 alone would be. A block
covers 8 x 16 output pixels, or 4 x 16 on a level whose 8-row tiles would
leave most SMs of the card idle (:func:`tile_rows`).
"""

from __future__ import annotations

import ctypes
from typing import Dict, List, Optional, Sequence, Tuple

import torch
import torch.nn.functional as F

from snn_automotive_object_detection_tpu_torch.utils import cuda_build as cb

NAME = "fpn_level"
FPN_CHANNELS = 256
BF = torch.bfloat16


def lateral_plain(c_feat: torch.Tensor, merged_next: Optional[torch.Tensor],
                  wlat: torch.Tensor, blat: torch.Tensor) -> torch.Tensor:
    """merged_l [N, H, W, 256] bf16: the lateral 1x1, its bias and the 2x
    nearest upsample of ``merged_next``, each step rounded to bf16."""
    n, h, w, cin = c_feat.shape
    lat = torch.matmul(c_feat.to(BF).float().reshape(-1, cin),
                       wlat.reshape(cin, -1).to(BF).float()).to(BF)
    merged = (lat + blat.to(BF)).reshape(n, h, w, -1)
    if merged_next is not None:
        up = merged_next.to(BF).repeat_interleave(2, dim=1).repeat_interleave(2, dim=2)
        merged = merged + up[:, :h, :w]
    return merged


def outer_plain(merged: torch.Tensor, wout: torch.Tensor,
                bout: torch.Tensor) -> torch.Tensor:
    """P_l [N, H, W, 256] bf16: the zero-padded 3x3 conv of the bf16 merged
    map, accumulated in f32 and rounded once, then its bias as a bf16 add."""
    y = F.conv2d(merged.float().permute(0, 3, 1, 2),
                 wout.to(BF).float().permute(3, 2, 0, 1), padding=1)
    return (y.to(BF) + bout.to(BF)[None, :, None, None]).permute(0, 2, 3, 1).contiguous()


def fpn_level_plain(c_feat: torch.Tensor, merged_next: Optional[torch.Tensor],
                    wlat: torch.Tensor, blat: torch.Tensor, wout: torch.Tensor,
                    bout: torch.Tensor, store_merged: bool
                    ) -> Tuple[torch.Tensor, Optional[torch.Tensor]]:
    """One FPN level, plain PyTorch. Same arguments and returns as
    :func:`fpn_level`."""
    cb.note_plain(NAME, c_feat)
    _check_shapes(c_feat, merged_next)
    merged = lateral_plain(c_feat, merged_next, wlat, blat)
    return outer_plain(merged, wout, bout), (merged if store_merged else None)


def _check_shapes(c_feat, merged_next) -> None:
    if c_feat.dim() != 4 or 0 in c_feat.shape:
        raise ValueError(f"fpn_level: expected a non-empty [N, H, W, Cin] map, "
                         f"got {tuple(c_feat.shape)}")
    if merged_next is not None:
        n, h, w, _ = c_feat.shape
        want = (n, (h + 1) // 2, (w + 1) // 2, FPN_CHANNELS)
        if tuple(merged_next.shape) != want:
            raise ValueError(f"fpn_level: the coarser merged map must be "
                             f"{want}, got {tuple(merged_next.shape)}")


def tile_rows(c_feat: torch.Tensor) -> int:
    """Output rows of a block's 16-column tile: 8, or 4 where 8-row tiles
    would leave more than half of the card's SMs without a block. A 4-row
    tile recomputes 1.69 lateral rows per output row, an 8-row tile 1.41,
    so on an H100 C4 of the flagship bucket (72 blocks of 8 rows on 132
    SMs) is faster with 8 rows and only C5 (18) takes 4 (PERF.md)."""
    n, h, w, _ = c_feat.shape
    sms = torch.cuda.get_device_properties(c_feat.device).multi_processor_count
    return 8 if 2 * n * -(-h // 8) * -(-w // 16) >= sms else 4


def _launch(c_feat: torch.Tensor, merged_next: Optional[torch.Tensor],
            wlat_t: torch.Tensor, blat: torch.Tensor, w9_t: torch.Tensor,
            bout: torch.Tensor, store_merged: bool, rows: Optional[int] = None):
    """K5 on one level. ``wlat_t`` [256, Cin] and ``w9_t`` [9, 256, 256]
    are the transposed weights (see :func:`fpn_level`); ``rows`` the tile's
    output rows, by default :func:`tile_rows`."""
    _check_shapes(c_feat, merged_next)
    n, h, w, cin = c_feat.shape
    c = FPN_CHANNELS
    cb.require(c_feat, "c_feat", BF)
    if cin % 32:
        raise ValueError(f"fpn_level kernel takes Cin a multiple of 32, got {cin}")
    if merged_next is not None:
        cb.require(merged_next, "merged_next", BF)
    cb.require(wlat_t, "wlat_t", BF, (c, cin))
    cb.require(blat, "blat", BF, (c,))
    cb.require(w9_t, "w9_t", BF, (9, c, c))
    cb.require(bout, "bout", BF, (c,))
    rows = tile_rows(c_feat) if rows is None else rows
    out_p = torch.empty((n, h, w, c), dtype=BF, device=c_feat.device)
    out_m = torch.empty((n, h, w, c), dtype=BF, device=c_feat.device) \
        if store_merged else None
    fn = cb.function(NAME, "fpn_level_bf16",
                     [ctypes.c_void_p] * 8 + [ctypes.c_int] * 5 + [ctypes.c_void_p])
    code = fn(c_feat.data_ptr(),
              None if merged_next is None else merged_next.data_ptr(),
              wlat_t.data_ptr(), blat.data_ptr(), w9_t.data_ptr(), bout.data_ptr(),
              out_p.data_ptr(), None if out_m is None else out_m.data_ptr(),
              n, h, w, cin, rows, cb.stream_ptr(c_feat.device))
    cb.check(code, NAME)
    cb.LAUNCHES[NAME] += 1
    return out_p, out_m


def kernel_weights(wlat: torch.Tensor, blat: torch.Tensor, wout: torch.Tensor,
                   bout: torch.Tensor):
    """The level's weights as :func:`_launch` takes them: (wlat_t [256,
    Cin], blat, w9_t [9, 256, 256] per tap [output, input], bout), bf16."""
    c = FPN_CHANNELS
    cin = wlat.numel() // c
    return (wlat.reshape(cin, c).t().to(BF).contiguous(), blat.to(BF).contiguous(),
            wout.reshape(9, c, c).transpose(1, 2).to(BF).contiguous(),
            bout.to(BF).contiguous())


def fpn_level(c_feat: torch.Tensor, merged_next: Optional[torch.Tensor],
              wlat: torch.Tensor, blat: torch.Tensor, wout: torch.Tensor,
              bout: torch.Tensor, store_merged: bool
              ) -> Tuple[torch.Tensor, Optional[torch.Tensor]]:
    """One FPN level: (P_l [N, H, W, 256] bf16, merged_l or None).

    c_feat [N, H, W, Cin] backbone stage output; merged_next [N,
    ceil(H/2), ceil(W/2), 256], the merged map of the level above (None for
    the top level); wlat [1, 1, Cin, 256] / blat [256] the lateral 1x1;
    wout [3, 3, 256, 256] HWIO / bout [256] the output conv.
    """
    if cb.dispatch_device(c_feat, NAME):
        return _launch(c_feat, merged_next, *kernel_weights(wlat, blat, wout, bout),
                       store_merged)
    return fpn_level_plain(c_feat, merged_next, wlat, blat, wout, bout, store_merged)


def fpn_apply(cs: Sequence[torch.Tensor], fpn_params: Dict) -> List[torch.Tensor]:
    """The whole FPN over the four backbone stages, top down: returns [P2,
    P3, P4, P5, pool] with pool = P5[:, ::2, ::2] (LastLevelMaxPool)."""
    inner, layer = fpn_params["inner"], fpn_params["layer"]
    merged = None
    outs: List[Optional[torch.Tensor]] = [None] * 4
    for i in (3, 2, 1, 0):
        outs[i], merged = fpn_level(cs[i], merged, inner[i]["w"], inner[i]["b"],
                                    layer[i]["w"], layer[i]["b"],
                                    store_merged=i > 0)
    outs.append(outs[3][:, ::2, ::2].contiguous())
    return outs
