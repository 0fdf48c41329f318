"""Spiking RPN head through the hand-written CUDA kernels: the forward of
the evaluation route (K1), the forward of the training route, the forward
for a pair of images (K8) and the backward for the weights (K7).

Replaces ``snn/pallas_rpn.py``: ``rpn_head_snn_pallas_apply`` with its
per-level ``_run_level`` (K1, ``csrc/rpn_head.cu``: one pass over the tap
weights for a chunk of 8 steps, ``wgmma``, TMA) and its paired
``_run_level_x2`` (K8, ``csrc/rpn_head_x2.cu``), and
``rpn_head_snn_pallas_train_apply`` with its forward
(``csrc/rpn_head_train.cu``) and ``_run_level_bwd`` as the custom VJP of
the level (K7, ``csrc/rpn_head_bwd.cu``). The training forward, K8 and
K7's replay run the same device code (``csrc/rpn_head_common.cuh``), so
their spikes are equal bits; K1 sums its products in another order.
:func:`rpn_level_plain`, :func:`rpn_level_x2_plain` and
:func:`rpn_level_bwd_plain` beside them are their plain PyTorch versions
and follow the TPU kernels' formulation: threshold-count encoder periods,
the conv current rounded to the plane dtype, f32 LIF states, an
LI-weighted spike sum with :func:`snnf.li_coefficients` and one fused
readout after the loop, rounded to the plane dtype; backwards, the replay
with stored decayed membranes, the reverse SuperSpike sweep written out
(no autograd) and the two weight-gradient products.

A CPU tensor takes the plain versions (bf16 or f32 planes); a CUDA tensor
launches the kernels, which take bf16 planes only, or raises.
:class:`RpnLevelTrain` ties the training forward and K7 into one
differentiable level.
"""

from __future__ import annotations

import ctypes
import torch
import torch.nn.functional as F

from snn_automotive_object_detection_tpu_torch.snn import functional as snnf
from snn_automotive_object_detection_tpu_torch.utils import cuda_build as cb
from snn_automotive_object_detection_tpu_torch.utils.constants import device_constant

NAME = "rpn_head"
TRAIN_NAME = "rpn_head_train"
BWD_NAME = "rpn_head_bwd"
X2_NAME = "rpn_head_x2"
# Whether the head outside training takes the paired kernel for the levels
# that can pair (see :func:`x2_feasible`) when no rates are collected.
# ``chip_smoke.check_rpn_x2`` times K8 against K1 in turns on the five
# flagship levels in every run. Off: on an H100 K1 takes 5.7-5.8 ms for
# them and K8 20.8 ms (PERF.md).
PAIR_IMAGES = False
# Split counts of the weight-gradient kernel: 36 tiles of dw9 times 11
# splits are three blocks for each of 132 SMs.
DW9_SPLITS = 11
DWOUT_SPLITS = 64
MAX_T = 32
MAX_OUT = 128


def _constants(num_steps: int, device) -> torch.Tensor:
    """[2T] float32 on ``device``: the encoder thresholds, then the LI
    coefficients."""
    return device_constant(tuple(snnf.encoder_thresholds(num_steps).tolist())
                           + tuple(snnf.li_coefficients(num_steps).tolist()),
                           torch.float32, device)


def _taps(w_shared: torch.Tensor) -> torch.Tensor:
    """[3, 3, C, C] HWIO -> [9, C, C] bf16, dy-major, [input, output]
    channels per tap, as the training forward, K7 and K8 take it."""
    c = w_shared.shape[2]
    return w_shared.reshape(9, c, c).to(torch.bfloat16).contiguous()


def _taps_t(w_shared: torch.Tensor) -> torch.Tensor:
    """[3, 3, C, C] HWIO -> [9, C, C] bf16, dy-major, [output, input]
    channels per tap: K1 reads each tap's rows by TMA as the K-major B of
    its products. One copy, as the cast to bf16 alone would be."""
    c = w_shared.shape[2]
    return w_shared.reshape(9, c, c).transpose(1, 2).to(torch.bfloat16).contiguous()


def _level_steps(feat: torch.Tensor, w_shared: torch.Tensor,
                 w_out: torch.Tensor, num_steps: int):
    """The T steps of one level on a batch of images: (readout, encoder
    counts, LIF spike counts, LI-weighted spike sums)."""
    cd = feat.dtype
    n, h, w, c = feat.shape
    consts = _constants(num_steps, feat.device)
    thr, li = consts[:num_steps], consts[num_steps:]
    periods = snnf.threshold_periods(feat.float(), thr)
    weight = w_shared.to(cd).permute(3, 2, 0, 1).contiguous()
    state = snnf.zeros_lif_state((n, h, w, c), device=feat.device)
    ssum = torch.zeros((n, h, w, c), dtype=torch.float32, device=feat.device)
    enc = torch.zeros(n, dtype=torch.int64, device=feat.device)
    lif = torch.zeros(n, dtype=torch.int64, device=feat.device)
    for t in range(num_steps):
        z = snnf.encoder_spikes_at(periods, t, cd)
        cur = F.conv2d(z.permute(0, 3, 1, 2), weight, padding=1)
        cur = cur.permute(0, 2, 3, 1).float()
        s, state = snnf.lif_feed_forward_step(cur, state)
        ssum = ssum + li[t] * s
        enc += z.sum(dim=(1, 2, 3), dtype=torch.int64)
        lif += s.sum(dim=(1, 2, 3), dtype=torch.int64)
    out = torch.matmul(ssum, w_out.to(cd).float()).to(cd).float()
    return out, enc, lif, ssum


def rpn_level_plain(feat: torch.Tensor, w_shared: torch.Tensor,
                    w_out: torch.Tensor, num_steps: int, spike_sum: bool = False):
    """One FPN level, plain PyTorch.

    feat [N, H, W, C] in the plane dtype (bf16 or f32); w_shared
    [3, 3, C, C] HWIO; w_out [C, n_out]. Returns (readout [N, H, W, n_out]
    float32 holding plane-dtype values, encoder counts [N] int64, LIF spike
    counts [N] int64), and with ``spike_sum`` also the LI-weighted spike sum
    [N, H, W, C] f32 of every neuron, for checks that count flipped spikes
    neuron by neuron.
    """
    cb.note_plain(NAME, feat)
    got = _level_steps(feat, w_shared, w_out, num_steps)
    return got if spike_sum else got[:3]


def x2_feasible(feat_shape) -> bool:
    """Whether a level [N, H, W, C] can take the paired kernel: an even
    batch of 256-channel planes whose pairs fit the grid. The kernel's
    shared memory (190 KB) does not depend on the level."""
    n, _, _, c = feat_shape
    return n > 0 and n % 2 == 0 and n // 2 <= 65535 and c == 256


def rpn_level_x2_plain(feat: torch.Tensor, w_shared: torch.Tensor,
                       w_out: torch.Tensor, num_steps: int,
                       spike_sum: bool = False):
    """One FPN level pair by pair, plain PyTorch: images 2p and 2p + 1 go
    through the steps together. feat [N, H, W, C] with N even. Returns the
    readout [N, H, W, n_out] f32, with ``spike_sum`` (readout, spike sums
    [N, H, W, C] f32); no spike counts. Per image the values are
    :func:`rpn_level_plain`'s."""
    cb.note_plain(X2_NAME, feat)
    if feat.shape[0] % 2:
        raise ValueError(f"the paired level takes an even batch, got {feat.shape[0]}")
    pairs = [_level_steps(feat[p:p + 2], w_shared, w_out, num_steps)
             for p in range(0, feat.shape[0], 2)]
    out = torch.cat([p[0] for p in pairs])
    return (out, torch.cat([p[3] for p in pairs])) if spike_sum else out


def _check_level(name, feat, w9, w_out, num_steps):
    n, h, w, c = feat.shape
    n_out = w_out.shape[1]
    cb.require(feat, "feat", torch.bfloat16)
    if c != 256:
        raise ValueError(f"{name} kernel takes 256 channels, got {c}")
    cb.require(w9, "w9", torch.bfloat16, (9, c, c))
    cb.require(w_out, "w_out", torch.bfloat16, (c, n_out))
    if not 1 <= num_steps <= MAX_T or not 1 <= n_out <= MAX_OUT:
        raise ValueError(f"{name} kernel takes T <= {MAX_T} and at most "
                         f"{MAX_OUT} readout channels")


def _launch_with(name: str, symbol: str, feat: torch.Tensor, w9: torch.Tensor,
                 w_out: torch.Tensor, num_steps: int, spike_sum: bool):
    n, h, w, c = feat.shape
    n_out = w_out.shape[1]
    _check_level(name, feat, w9, w_out, num_steps)
    consts = _constants(num_steps, feat.device)
    out = torch.empty((n, h, w, n_out), dtype=torch.float32, device=feat.device)
    counts = torch.zeros((n, 2), dtype=torch.int64, device=feat.device)
    ssum = (torch.empty((n, h, w, c), dtype=torch.float32, device=feat.device)
            if spike_sum else None)
    fn = getattr(cb.load(name), symbol)
    fn.restype = ctypes.c_int
    fn.argtypes = [ctypes.c_void_p] * 7 + [ctypes.c_int] * 5 + [ctypes.c_void_p]
    code = fn(feat.data_ptr(), w9.data_ptr(), w_out.data_ptr(), consts.data_ptr(),
              out.data_ptr(), counts.data_ptr(),
              None if ssum is None else ssum.data_ptr(), n, h, w, num_steps,
              n_out, cb.stream_ptr(feat.device))
    cb.check(code, name)
    cb.LAUNCHES[name] += 1
    if spike_sum:
        return out, counts[:, 0], counts[:, 1], ssum
    return out, counts[:, 0], counts[:, 1]


def _launch(feat: torch.Tensor, w9_t: torch.Tensor, w_out: torch.Tensor,
            num_steps: int, spike_sum: bool = False):
    """K1 on one level; ``w9_t`` from :func:`_taps_t`. Same returns as
    :func:`rpn_level_plain`."""
    return _launch_with(NAME, "rpn_level_bf16", feat, w9_t, w_out, num_steps, spike_sum)


def _launch_train(feat: torch.Tensor, w9: torch.Tensor, w_out: torch.Tensor,
                  num_steps: int, spike_sum: bool = False):
    """The training forward on one level; ``w9`` from :func:`_taps`. Same
    returns as :func:`rpn_level_plain`, and the same spikes as K7's replay
    and K8 bit for bit."""
    return _launch_with(TRAIN_NAME, "rpn_level_train_bf16", feat, w9, w_out,
                        num_steps, spike_sum)


def _launch_x2(feat: torch.Tensor, w9: torch.Tensor, w_out: torch.Tensor,
               num_steps: int, spike_sum: bool = False):
    """K8 on one level. Same returns as :func:`rpn_level_x2_plain`."""
    n, h, w, c = feat.shape
    n_out = w_out.shape[1]
    _check_level(X2_NAME, feat, w9, w_out, num_steps)
    if not x2_feasible(feat.shape):
        raise ValueError(f"{X2_NAME} kernel takes an even batch, got {n}")
    consts = _constants(num_steps, feat.device)
    out = torch.empty((n, h, w, n_out), dtype=torch.float32, device=feat.device)
    ssum = (torch.empty((n, h, w, c), dtype=torch.float32, device=feat.device)
            if spike_sum else None)
    fn = cb.load(X2_NAME).rpn_level_x2_bf16
    fn.restype = ctypes.c_int
    fn.argtypes = [ctypes.c_void_p] * 6 + [ctypes.c_int] * 5 + [ctypes.c_void_p]
    code = fn(feat.data_ptr(), w9.data_ptr(), w_out.data_ptr(), consts.data_ptr(),
              out.data_ptr(), None if ssum is None else ssum.data_ptr(), n, h, w,
              num_steps, n_out, cb.stream_ptr(feat.device))
    cb.check(code, X2_NAME)
    cb.LAUNCHES[X2_NAME] += 1
    return (out, ssum) if spike_sum else out


def rpn_level(feat: torch.Tensor, w_shared: torch.Tensor, w_out: torch.Tensor,
              num_steps: int, spike_sum: bool = False):
    """One level on the evaluation route: K1 (CUDA) or the plain version
    (CPU). Same returns as :func:`rpn_level_plain`."""
    if cb.dispatch_device(feat, NAME):
        return _launch(feat, _taps_t(w_shared), w_out.to(torch.bfloat16).contiguous(),
                       num_steps, spike_sum)
    return rpn_level_plain(feat, w_shared, w_out, num_steps, spike_sum)


def rpn_level_train(feat: torch.Tensor, w_shared: torch.Tensor, w_out: torch.Tensor,
                    num_steps: int, spike_sum: bool = False):
    """One level on the training route: the training forward (CUDA), whose
    spikes K7 replays, or the plain version (CPU). Same returns as
    :func:`rpn_level_plain`."""
    if cb.dispatch_device(feat, TRAIN_NAME):
        return _launch_train(feat, _taps(w_shared), w_out.to(torch.bfloat16).contiguous(),
                             num_steps, spike_sum)
    return rpn_level_plain(feat, w_shared, w_out, num_steps, spike_sum)


def rpn_level_x2(feat: torch.Tensor, w_shared: torch.Tensor, w_out: torch.Tensor,
                 num_steps: int, spike_sum: bool = False):
    """One level pair by pair through the paired kernel (CUDA) or its plain
    version (CPU). Same returns as :func:`rpn_level_x2_plain`."""
    if cb.dispatch_device(feat, X2_NAME):
        return _launch_x2(feat, _taps(w_shared), w_out.to(torch.bfloat16).contiguous(),
                          num_steps, spike_sum)
    return rpn_level_x2_plain(feat, w_shared, w_out, num_steps, spike_sum)


def rpn_level_bwd_plain(feat: torch.Tensor, w_shared: torch.Tensor,
                        w_out: torch.Tensor, g: torch.Tensor, num_steps: int,
                        spike_sum: bool = False):
    """Backward of one level for its weights, plain PyTorch, written out
    step by step (no autograd).

    feat [N, H, W, C] in the plane dtype (bf16 or f32); w_shared
    [3, 3, C, C]; w_out [C, n_out]; g [N, H, W, n_out] f32, the cotangent
    of the readout. Returns (dw_shared [3, 3, C, C] f32, dw_out [C, n_out]
    f32), and with ``spike_sum`` also the replay's LI-weighted spike sum
    [N, H, W, C] f32, which must equal the forward's.
    """
    cb.note_plain(BWD_NAME, feat)
    cd = feat.dtype
    n, h, w, c = feat.shape
    p = snnf.LIF_PARAMS
    tau_mem, tau_syn = snnf.DT * p.tau_mem_inv, snnf.DT * p.tau_syn_inv
    consts = _constants(num_steps, feat.device)
    thr, li = consts[:num_steps], consts[num_steps:]
    periods = snnf.threshold_periods(feat.float(), thr)
    weight = w_shared.to(cd).permute(3, 2, 0, 1).contiguous()

    # Replay of the forward, keeping each step's decayed membrane.
    state = snnf.zeros_lif_state((n, h, w, c), device=feat.device)
    ssum = torch.zeros((n, h, w, c), dtype=torch.float32, device=feat.device)
    vds = []
    for t in range(num_steps):
        z = snnf.encoder_spikes_at(periods, t, cd)
        cur = F.conv2d(z.permute(0, 3, 1, 2), weight, padding=1)
        cur = cur.permute(0, 2, 3, 1).float()
        vds.append(state.v + tau_mem * ((p.v_leak - state.v) + state.i))
        s, state = snnf.lif_feed_forward_step(cur, state)
        ssum = ssum + li[t] * s

    # Reverse sweep: only gw sees the cotangent rounded to the plane dtype.
    g = g.float()
    # gw = bf16(g) @ wout^T summed over the readout channels in order, each
    # product and each add rounded to f32, as the kernel sums it.
    g_cd, wo_cd = g.to(cd).float(), w_out.to(cd).float()
    gw = torch.zeros_like(ssum)
    for j in range(w_out.shape[1]):
        gw = gw + g_cd[..., j:j + 1] * wo_cd[:, j]
    lv = torch.zeros_like(ssum)
    lam = torch.zeros_like(ssum)
    # The products of dw9 are exact (0/1 spikes times plane-dtype values);
    # summed in f64, so that this version's own sums over up to a million
    # pixels and steps carry no f32 rounding of their own.
    dw9 = torch.zeros((9, c, c), dtype=torch.float64, device=feat.device)
    for t in reversed(range(num_steps)):
        z = snnf.encoder_spikes_at(periods, t, cd).double()
        zp = F.pad(z, (0, 0, 1, 1, 1, 1))
        dc = lam.to(cd).double().reshape(-1, c)      # lam before this step's update
        for k in range(9):
            dy, dx = divmod(k, 3)
            dw9[k] += torch.matmul(
                zp[:, dy:dy + h, dx:dx + w].reshape(-1, c).t(), dc)
        vd = vds[t]
        u = vd - p.v_th
        sp = 1.0 / (p.alpha * u.abs() + 1.0) ** 2    # SuperSpike
        ds = li[t] * gw - vd * lv
        dvd = (1.0 - (u > 0).float()) * lv + ds * sp
        lv = (1.0 - tau_mem) * dvd
        lam = tau_mem * dvd + (1.0 - tau_syn) * lam
    dw_out = dwout_plain(ssum, g)
    dw_shared = dw9.float().reshape(3, 3, c, c)
    return (dw_shared, dw_out, ssum) if spike_sum else (dw_shared, dw_out)


def dwout_plain(ssum: torch.Tensor, g: torch.Tensor) -> torch.Tensor:
    """The readout's weight gradient ssum^T @ g, [C, n_out] f32, from the
    LI-weighted spike sums [N, H, W, C] and the f32 cotangent. It is linear
    in the spike sums, so a check can hold K7's ``dw_out`` against this
    product of K7's own replayed sums where the forward kernel and its
    plain version differ in a spike."""
    c = ssum.shape[-1]
    return torch.matmul(ssum.reshape(-1, c).t(), g.float().reshape(-1, g.shape[-1]))


def _splits(n_chunks: int, target: int) -> int:
    """At most ``target`` splits of ``n_chunks`` chunks, none of them empty."""
    per = -(-n_chunks // target)
    return -(-n_chunks // per)


def _launch_bwd(feat: torch.Tensor, w9: torch.Tensor, w_out: torch.Tensor,
                g: torch.Tensor, num_steps: int, spike_sum: bool = False):
    """K7 on one level. Returns (dw9 [9, C, C] f32, dw_out [C, n_out] f32)
    and with ``spike_sum`` the replay's spike sum."""
    n, h, w, c = feat.shape
    n_out = w_out.shape[1]
    _check_level(BWD_NAME, feat, w9, w_out, num_steps)
    cb.require(g, "g", torch.float32, (n, h, w, n_out))
    dev = feat.device
    consts = _constants(num_steps, dev)
    n_chunks = n * h * (-(-w // 32))
    s9, s_out = _splits(n_chunks, DW9_SPLITS), _splits(n_chunks, DWOUT_SPLITS)
    f32 = torch.float32
    vd = torch.empty(n_chunks * num_steps * 16 * 512, dtype=f32, device=dev)
    per = torch.empty((n, h, w, c), dtype=torch.uint8, device=dev)
    dc = torch.empty((n, h, w, num_steps, c), dtype=torch.bfloat16, device=dev)
    ssum = torch.empty((n, h, w, c), dtype=f32, device=dev)
    part9 = torch.empty((s9 if s9 > 1 else 0, 9, c, c), dtype=f32, device=dev)
    part_out = torch.empty((s_out, c, n_out), dtype=f32, device=dev)
    counters = torch.zeros(37, dtype=torch.int32, device=dev)
    dw9 = torch.empty((9, c, c), dtype=f32, device=dev)
    dw_out = torch.empty((c, n_out), dtype=f32, device=dev)
    fn = cb.load(BWD_NAME).rpn_level_bwd_bf16
    fn.restype = ctypes.c_int
    fn.argtypes = [ctypes.c_void_p] * 14 + [ctypes.c_int] * 7 + [ctypes.c_void_p]
    code = fn(feat.data_ptr(), w9.data_ptr(), w_out.data_ptr(), consts.data_ptr(),
              g.data_ptr(), vd.data_ptr(), per.data_ptr(), dc.data_ptr(),
              ssum.data_ptr(), part9.data_ptr(), part_out.data_ptr(),
              counters.data_ptr(), dw9.data_ptr(), dw_out.data_ptr(), n, h, w,
              num_steps, n_out, s9, s_out, cb.stream_ptr(dev))
    cb.check(code, BWD_NAME)
    cb.LAUNCHES[BWD_NAME] += 1
    return (dw9, dw_out, ssum) if spike_sum else (dw9, dw_out)


def rpn_level_bwd(feat: torch.Tensor, w_shared: torch.Tensor, w_out: torch.Tensor,
                  g: torch.Tensor, num_steps: int, spike_sum: bool = False):
    """Weight gradients of one level through the kernel (CUDA) or the plain
    version (CPU). Same returns as :func:`rpn_level_bwd_plain`."""
    if cb.dispatch_device(feat, BWD_NAME):
        got = _launch_bwd(feat, _taps(w_shared), w_out.to(torch.bfloat16).contiguous(),
                          g.float().contiguous(), num_steps, spike_sum)
        return (got[0].reshape(w_shared.shape),) + got[1:]
    return rpn_level_bwd_plain(feat, w_shared, w_out, g, num_steps, spike_sum)


class RpnLevelTrain(torch.autograd.Function):
    """One differentiable level: forward is :func:`rpn_level_train` (the
    training forward on a CUDA tensor), backward :func:`rpn_level_bwd` (K7),
    which replays it. Only ``feat``,
    ``w_shared`` and ``w_out`` are kept for the backward, which replays the
    forward. The features get no gradient: the backbone is frozen wherever
    this route is taken."""

    @staticmethod
    def forward(ctx, feat, w_shared, w_out, num_steps):
        out, enc, lif = rpn_level_train(feat, w_shared, w_out, num_steps)
        ctx.save_for_backward(feat, w_shared, w_out)
        ctx.num_steps = num_steps
        ctx.mark_non_differentiable(enc, lif)
        return out, enc, lif

    @staticmethod
    def backward(ctx, g_out, _g_enc, _g_lif):
        feat, w_shared, w_out = ctx.saved_tensors
        dw_shared, dw_out = rpn_level_bwd(feat, w_shared, w_out, g_out,
                                          ctx.num_steps)
        return None, dw_shared.to(w_shared.dtype), dw_out.to(w_out.dtype), None
